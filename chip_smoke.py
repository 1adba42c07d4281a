#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``src/repro_torch``) runs on one
NVIDIA card: builds the hand-written kernels, holds each against its plain
PyTorch version at the shapes of the main path, drives the layout-contrast
entry point (``launch/kernel_demo.py::layout_contrast``) at full width,
decodes over a cache split along "kv_seq" (the attention kernel on blocks
of the ring returning its softmax partials, merged as ranks merge them),
then serves full-width qwen2-7b and gemma2-9b on worlds of two gloo ranks
on this card (the cache split along "kv_seq" with the weights whole, and
tensor-parallel under the serving rules, heads, MLP and vocab split too,
every collective through the port's own c10d path), each held to the
unsharded run, then drives the hotmem ``ServeEngine`` on
full-width qwen2-7b (random weights from a seed) through cold start,
warm start, snapshot capture,
restore, the paged copy-on-write remap, plug and unplug, and the vanilla
paged ``ServeEngine`` through the same bursty trace and a scripted unplug
that must migrate blocks, then two full-width replicas on one host budget
through the cluster layer (``launch/cluster_demo.py``): a scripted steal
per mode, the demo's two-replica trace under the sync and the async
broker, and two hosts whose late tail restores remotely; then the
paper's end-to-end scenario (``launch/serve_elastic.py``: hotmem, vanilla
and static on one bursty trace) at full width; then the other
decoder families one after the other, each freed before the next:
full-width mamba2-780m, recurrentgemma-2b, gemma2-9b and mixtral-8x7b (16
of its 32 layers: the whole model does not fit the card) through the
snapshot kernels over their cache trees, ``partition_attention`` at their
decode shapes (logit cap and query scale included), decode against the
train forward (gemma2's forward on 8192 tokens through the chunked
attention path, held against the plain path at one layer's shapes too),
and the hotmem engine's snapshot, paged copy-on-write and bursty
schedules; and qwen2-vl-72b (8 of 80 layers) at the model level, with
M-RoPE positions and the vision stub; then training: full-width
tinyllama-1.1b through ``launch/train.py``'s step at 8 x 1024 tokens
(grad accumulation, memorising a batch, the step's time and device time,
peak memory with and without remat) and a crash and resume of reduced
qwen2-1.5b through ``launch/train.py``; then the sharding layer on a world
of one (NCCL, the (1, 1) host mesh): the same training on the mesh, its
losses held to the unsharded run's, a reshard on load, one full-width
mixtral MoE layer through the shard-map path against the dense one, and
the cluster demo's trace on a two-device sharded host; then the analysis
tools: the roofline of the measured qwen2-7b decode step and tinyllama
train step (``repro_torch.roofline``) beside their measured times, and the
dry run of two cells and the hill-climb's int8 pair on this machine's
torch (``launch/dryrun.py``, in a subprocess); then full-width
seamless-m4t-medium at the model level: the snapshot kernels over its
self and cross K/V, ``partition_attention`` at its head dim 64, the encoder
over stub frames, prefill, decode against the train forward and a train
step; it checks what comes out.

    python3 chip_smoke.py
    python3 chip_smoke.py worlds      # the build and the two-rank worlds

Every phase prints a JSON line (the cluster phase a second one with every
steal's wall).  The script fails (raises, non-zero exit)
when there is no CUDA device, when a kernel does not build, launch or agree
with its plain version, or when any check of the engine run fails.  A
``summary`` line repeats the engine's headline figures near the end.  The
last three lines are the kernel table, the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from collections import deque
from functools import lru_cache, partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import roofline  # noqa: E402
from repro_torch.cluster.host import HostMemoryBroker  # noqa: E402
from repro_torch.cluster.topology import DeviceTopology  # noqa: E402
from repro_torch.configs.base import (ShapeCell, get_config,  # noqa: E402
                                      reduced)
from repro_torch.core.arena import ArenaSpec  # noqa: E402
from repro_torch.core.elastic import gather_blocks  # noqa: E402
from repro_torch.kernels import kv_snapshot, ops, ref  # noqa: E402
from repro_torch.kernels.partition_attention import (  # noqa: E402
    block_runs, splits_for)
from repro_torch.launch.attention_cases import (  # noqa: E402
    ENGINE_ROWS, TOL_BF16, TOL_F32, allclose, attention_close,
    edge_positions, engine_positions, mean_of_v)
from repro_torch.launch.cluster_demo import (build_cluster,  # noqa: E402
                                             demo_requests, host_budget,
                                             load_model, summarize)
from repro_torch.launch.kernel_demo import (layout_contrast,  # noqa: E402
                                            scatter_to_pool)
from repro_torch.launch import distributed, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve_elastic import serve_elastic  # noqa: E402
from repro_torch.launch.specs import (batch_specs,  # noqa: E402
                                      train_state_specs)
from repro_torch.launch.train import (batch_to_mesh, make_batch,  # noqa: E402
                                      scalar, state_shardings, train)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.attention import merge_partials  # noqa: E402
from repro_torch.models.layers import (materialize,  # noqa: E402
                                       rope_freqs, tree_leaves, tree_map)
from repro_torch.sharding import (DP_ONLY_TRAIN_RULES,  # noqa: E402
                                  current_ctx, distribute, is_dtensor,
                                  named_sharding, sharding_ctx,
                                  train_rules_for)
from repro_torch.serving.engine import (ServeEngine,  # noqa: E402
                                        assemble_pages)
from repro_torch.serving.request import (PROFILES,  # noqa: E402
                                         FunctionProfile, Request, State)
from repro_torch.serving.tracegen import (assign_profiles,  # noqa: E402
                                          bursty_trace)
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import (DataConfig,  # noqa: E402
                                       SyntheticTokens)
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            init_opt_state)
from repro_torch.training.train_step import make_train_step  # noqa: E402

ARCH = "qwen2-7b"
PARTITION_TOKENS, N_PARTITIONS, BLOCK_TOKENS = 2048, 8, 32
PAGE_BYTES = 2 << 20            # paged CoW: 56 pages of one 112 MiB row
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


def _valid_slots(pos: torch.Tensor, t: int, window: int = 0) -> int:
    """Ring slots holding a token at or before each row's position, within
    the window (0: none): the K/V the function needs to read for this
    run's data."""
    n = pos.long() + 1
    if window:
        n = torch.clamp(n, max=window)
    return int(torch.clamp(n, min=0, max=t).sum())


def _sdpa_call(q, k, v, pos, scale: float, window: int = 0):
    """One SDPA call computing the ring attention of q (P, Hkv, G, Dh) on
    k/v (P, T, Hkv, Dh): the GQA unrolled (K/V repeated per query head)
    and the ring and window mask built here, outside any timing."""
    p, hkv, g, dh = q.shape
    t = k.shape[1]
    slots = torch.arange(t, device=DEV)[None, :]
    at = pos.long()[:, None]
    gidx = at - torch.remainder(at - slots, t)
    mask = gidx >= 0
    if window:
        mask &= gidx > at - window
    qs = q.reshape(p, hkv * g, 1, dh)
    ks = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    vs = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    return lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask[:, None, None, :], scale=scale)


@lru_cache(maxsize=None)
def _flex(cap: float):
    """``flex_attention`` compiled once, with a tanh logit cap of ``cap``
    as its ``score_mod``."""
    from torch.nn.attention.flex_attention import flex_attention

    def capped(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / cap) * cap
    fn = torch.compile(flex_attention)
    return partial(fn, score_mod=capped)


def _flex_call(q, k, v, pos, scale: float, window: int, cap: float):
    """One compiled ``flex_attention`` call computing the ring attention of
    q (P, Hkv, G, Dh) on k/v (P, T, Hkv, Dh) under a tanh logit cap: the
    cap as its ``score_mod``, the ring and window validity as its block
    mask (built here, and compiled by the first call, outside any timing),
    the GQA as ``enable_gqa``."""
    from torch.nn.attention.flex_attention import create_block_mask
    p, hkv, g, dh = q.shape
    t = k.shape[1]
    at = pos.long()

    def valid(b, h, q_idx, kv_idx):
        gidx = at[b] - (at[b] - kv_idx) % t
        ok = gidx >= 0
        if window:
            ok = ok & (gidx > at[b] - window)
        return ok
    mask = create_block_mask(valid, p, None, 1, t, device=DEV)
    qs = q.reshape(p, hkv * g, 1, dh)
    ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (k, v))
    fn = _flex(cap)
    return lambda: fn(qs, ks, vs, block_mask=mask, scale=scale,
                      enable_gqa=True)


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
    edge = torch.tensor(edge_positions(t), dtype=torch.int32, device=DEV)
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
            ok, err, limit = attention_close(got[p - 1],
                                             mean_of_v(v[p - 1], g))
            check(ok, f"partition_attention {name}, pos -1: error {err} "
                      f"from the mean of V within {limit}")
            errs[name + "_pos-1_vs_mean_v"] = err
    # the engine's shape in the saturated cell: 64 rows at the positions
    # the mix binds, the edge rows in place of the first function's eight
    # (drawn from a generator of their own, so the other cases keep theirs)
    gen64 = torch.Generator(device=DEV).manual_seed(64)
    q64 = randn((ENGINE_ROWS, hkv, g, dh), bf16, gen64)
    k64 = randn((ENGINE_ROWS, t, hkv, dh), bf16, gen64)
    v64 = randn((ENGINE_ROWS, t, hkv, dh), bf16, gen64)
    sat = torch.from_numpy(engine_positions(0)).to(DEV)
    sat_edges = sat.clone()
    sat_edges[:len(edge)] = edge
    for w in (0, 100):
        name = f"p64_saturated_edges_w{w}"
        got = ops.partition_attention(q64, k64, v64, sat_edges, window=w)
        ok, err, limit = attention_close(
            got, ref.partition_attention(q64, k64, v64, sat_edges, window=w))
        check(ok, f"partition_attention {name}: error {err} within "
                  f"{TOL_BF16} and {limit}")
        errs[name], limits[name] = err, limit
        masked = edge_positions(t).index(-1)
        ok, err, limit = attention_close(got[masked],
                                         mean_of_v(v64[masked], g))
        check(ok, f"partition_attention {name}, pos -1: error {err} from "
                  f"the mean of V within {limit}")
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
    sdpa = _sdpa_call(q, k, v, lo, dh ** -0.5)
    _, sdpa_err = allclose(sdpa().reshape(p, hkv, g, dh),
                           ref.partition_attention(q, k, v, lo), TOL_BF16)

    valid = _valid_slots(lo, t)
    item = q.element_size()
    nbytes = 2 * valid * hkv * dh * item + 2 * q.numel() * item + 4 * p
    flops = 4.0 * valid * hkv * g * dh
    bound_s, bound_by = roofline.bound_seconds(nbytes, flops)
    kernel = lambda: ops.partition_attention(q, k, v, lo)  # noqa: E731
    plain = lambda: ref.partition_attention(q, k, v, lo)  # noqa: E731
    # three more shapes, timed for the kernel line only: one row at its
    # ring's end, eight rows at positions <= 256, and the engine's 64 rows
    # at the saturated mix's positions
    short = torch.randint(0, 257, (p,), generator=gen, device=DEV,
                          dtype=torch.int32)
    extra = []
    for name, args in (
            ("p1_pos2047", (q[:1], k[:1], v[:1], torch.tensor(
                [t - 1], dtype=torch.int32, device=DEV))),
            ("p8_pos_le_256", (q, k, v, short)),
            ("p64_saturated", (q64, k64, v64, sat))):
        rows, pos = args[0].shape[0], args[3]
        n_valid = _valid_slots(pos, t)
        extra.append({**_timed_shape(
            name, n_valid, partial(ops.partition_attention, *args),
            partial(ref.partition_attention, *args),
            2 * n_valid * hkv * dh * item + 2 * rows * hkv * g * dh * item
            + 4 * rows, 4.0 * n_valid * hkv * g * dh),
            "splits": splits_for(ops.load(), args[0], t)})
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


def _attention_windows(cfg) -> list[int]:
    """The windows of the model's attention blocks, in block order, each
    once (``_window_for``: the local window, 0 for global blocks, the
    sliding window of ``attn`` blocks; 0 for the encoder-decoder's
    self-attention)."""
    if cfg.family == "audio":
        return [0]
    kinds = [k for k in cfg.block_pattern + cfg.tail_pattern
             if k in transformer.ATTN_KINDS]
    return list(dict.fromkeys(transformer._window_for(cfg, k)
                              for k in kinds))


def phase_attention_at(cfg, gen, tag: str) -> dict:
    """``partition_attention`` at a model's own decode shapes: P = 8 rows of
    the arena's ring, T = ``min(PARTITION_TOKENS, window)`` slots (the
    engine's caches hold 2048 tokens whatever the window), the model's
    logit cap and query scale.  Positions below T, rings wrapped past T and
    a window of 512, then each window of the model's blocks over the ring
    and below T, each against the plain version; the engine's call (the
    first block's window, positions below T) timed against its byte bound
    and one PyTorch call (SDPA, or under a logit cap a compiled
    ``flex_attention`` with the cap as its ``score_mod``), and the other
    windows' calls timed in ``more_shapes``."""
    p, hkv, dh = N_PARTITIONS, cfg.num_kv_heads, cfg.head_dim
    windows = _attention_windows(cfg)
    t = PARTITION_TOKENS
    g = cfg.num_heads // hkv
    scale = cfg.query_scale or dh ** -0.5
    cap = cfg.attn_logit_softcap
    bf16 = torch.bfloat16
    q = randn((p, hkv, g, dh), bf16, gen)
    k = randn((p, t, hkv, dh), bf16, gen)
    v = randn((p, t, hkv, dh), bf16, gen)
    lo = torch.randint(0, t, (p,), generator=gen, device=DEV,
                       dtype=torch.int32)
    ring = torch.randint(t, 3 * t, (p,), generator=gen, device=DEV,
                         dtype=torch.int32)
    model = {"logit_cap": cap, "scale": scale}
    cases = [("below_T", lo, {}), ("ring", ring, {}),
             ("ring_window_512", ring, {"window": 512})]
    for w in windows:
        if w:
            cases += [(f"ring_window_{w}", ring, {"window": w}),
                      (f"below_T_window_{w}", lo, {"window": w})]
    errs, limits = {}, {}
    for name, pos, kw in cases:
        kw = {**kw, **model}
        ok, err, limit = attention_close(
            ops.partition_attention(q, k, v, pos, **kw),
            ref.partition_attention(q, k, v, pos, **kw))
        check(ok, f"partition_attention@{tag} {name}: error {err} within "
                  f"{TOL_BF16} and {limit}")
        errs[name], limits[name] = err, limit

    item = q.element_size()
    timed = []
    for window in windows:
        kw = {"window": window, **model}
        # SDPA has no logit cap: under a cap the yardstick is flex_attention
        # (below), and SDPA's time on the same inputs without the cap is
        # kept beside it for scale
        sdpa = _sdpa_call(q, k, v, lo, scale, window)
        _, sdpa_err = allclose(
            sdpa().reshape(p, hkv, g, dh),
            ref.partition_attention(q, k, v, lo, window=window, scale=scale),
            TOL_BF16)
        sdpa_ms = median_ms(sdpa)
        flex = flex_err = None
        if cap:
            flex = _flex_call(q, k, v, lo, scale, window, cap)
            _, flex_err = allclose(
                flex().reshape(p, hkv, g, dh),
                ref.partition_attention(q, k, v, lo, **kw), TOL_BF16)
        valid = _valid_slots(lo, t, window)
        nbytes = 2 * valid * hkv * dh * item + 2 * q.numel() * item + 4 * p
        flops = 4.0 * valid * hkv * g * dh
        bound_s, bound_by = roofline.bound_seconds(nbytes, flops)
        timed.append({
            "window": window, "valid_slots": valid, "bytes": nbytes,
            "flops": flops, "sdpa_max_abs_err": sdpa_err,
            "ms": median_ms(partial(ops.partition_attention, q, k, v, lo,
                                    **kw)),
            "plain_ms": median_ms(partial(ref.partition_attention, q, k, v,
                                          lo, **kw)),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": median_ms(flex) if cap else sdpa_ms,
            "library": "flex_attention (compiled, tanh score_mod)" if cap
            else "scaled_dot_product_attention",
            "library_max_abs_err": flex_err if cap else sdpa_err,
            "sdpa_without_cap_ms": sdpa_ms})
    main = timed[0]
    row = {"name": f"partition_attention@{tag}", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/partition_attention.cu",
           "replaces": "src/repro/kernels/partition_attention.py:70",
           "path": "family",
           "max_abs_err": max(errs.values()),
           **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}
    emit({"phase": "kernel", "config": cfg.name, **_cut(cfg),
          "shape": [p, t, hkv, g, dh], "dtype": "bf16", "windows": windows,
          "logit_cap": cap, "scale": scale,
          "splits": splits_for(ops.load(), q, t),
          "errors": errs, "tight_limits": limits,
          **{k: main[k] for k in ("window", "valid_slots", "bytes", "flops",
                                  "sdpa_max_abs_err", "sdpa_without_cap_ms",
                                  "library", "library_max_abs_err")},
          "more_shapes": timed[1:], **row})
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


def phase_decode_qkv_rope(cfg) -> dict:
    """``decode_qkv_rope`` at the saturated cell's shapes: 64 rows of
    qwen2-7b's projections with their biases, rows of 2,048 slots, one
    block's cache; bit-equal to its plain version on the card (q and both
    caches), every slot but the written ones unchanged.  Its own generator,
    so that the later phases draw what they drew."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2)
    p, t, hkv, dh = 64, PARTITION_TOKENS, cfg.num_kv_heads, cfg.head_dim
    hq = cfg.num_heads
    bf16 = torch.bfloat16
    q, k, v = (randn((p, n * dh), bf16, gen) for n in (hq, hkv, hkv))
    bq, bk, bv = (randn((n * dh,), bf16, gen) for n in (hq, hkv, hkv))
    kc, vc = (randn((p, t, hkv, dh), bf16, gen) for _ in range(2))
    pos = torch.randint(-1, 3 * t, (p,), generator=gen, device=DEV,
                        dtype=torch.int32)
    freqs = rope_freqs(dh, cfg.rope_theta, DEV)
    kp, vp, k0, v0 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    args = (q, k, v, bq, bk, bv, pos, freqs)
    got = ops.decode_qkv_rope(*args, kc, vc)
    want = ref.decode_qkv_rope(*args, kp, vp)
    torch.cuda.synchronize()

    def bits(x):
        return x.view(torch.int16)
    written = torch.zeros((p, t), dtype=torch.bool, device=DEV)
    written[torch.arange(p, device=DEV), torch.remainder(pos.long(), t)] \
        = True
    check(torch.equal(bits(got), bits(want)),
          "decode_qkv_rope q bit-exact against its plain version")
    check(torch.equal(bits(kc), bits(kp)) and torch.equal(bits(vc),
                                                          bits(vp)),
          "decode_qkv_rope caches bit-exact against its plain version")
    check(torch.equal(bits(kc[~written]), bits(k0[~written]))
          and torch.equal(bits(vc[~written]), bits(v0[~written])),
          "decode_qkv_rope left every other slot unchanged")
    del kp, vp, k0, v0
    item = 2
    nbytes = item * (2 * p * hq * dh + 4 * p * hkv * dh
                     + (hq + 2 * hkv) * dh) + 4 * p + 4 * dh // 2
    flops = p * (hq + 2 * hkv) * dh + 7.0 * p * (hq + hkv) * dh // 2
    bound_s, bound_by = roofline.bound_seconds(nbytes, flops)
    row = {"name": "decode_qkv_rope", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_qkv_rope.cu",
           "replaces": "none: the bias adds, RoPE and cache write of "
                       "src/repro/models/attention.py, which XLA fuses",
           "path": "engine", "max_abs_err": 0.0,
           "ms": median_ms(lambda: ops.decode_qkv_rope(*args, kc, vc)),
           "plain_ms": median_ms(lambda: ref.decode_qkv_rope(*args, kc,
                                                             vc)),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "library_ms": None}
    emit({"phase": "kernel", "shape": [p, t, hq, hkv, dh], "dtype": "bf16",
          "bytes": nbytes, "flops": flops,
          "library": "none: no single PyTorch call computes it", **row})
    return row


def phase_snapshot(cfg, gen, tag: str = "") -> list[dict]:
    """The two snapshot kernels over the model's full 8 x 2048 cache tree,
    filled with random bytes.  ``tag`` names the kernel line's rows
    (``snapshot_capture@<tag>``) of a model other than the main path's."""
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
    # the leaves' row slices where they share one shape (else one
    # multi-tensor copy of the slices into the blob's parts: torch.cat
    # would need a flatten, which copies a strided slice first), and one
    # multi-tensor copy of the blob's slices back into them
    sel = [leaf.select(ax, 5) for leaf, ax in zip(leaves, axes)]

    def blob_parts(b):
        return [b[0, s.offset:s.offset + s.size].view(x.shape)
                for s, x in zip(layout.slots, sel)]

    if len({x.shape for x in sel}) == 1:
        lib_name = "torch.cat"
        lib_capture = lambda: torch.cat(sel)  # noqa: E731
        lib_blob = lambda: lib_capture().reshape(1, -1)  # noqa: E731
    else:
        lib_name = "torch._foreach_copy_"
        out_blob = torch.empty_like(blob)
        out_parts = blob_parts(out_blob)
        lib_capture = lambda: torch._foreach_copy_(  # noqa: E731
            out_parts, sel)

        def lib_blob():
            lib_capture()
            return out_blob
    check(torch.equal(bits(lib_blob()), bits(blob)),
          f"{lib_name} of the row slices equals the blob")

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
    suffix = f"@{tag}" if tag else ""
    out = [
        {"name": "snapshot_capture" + suffix, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kv_snapshot.cu",
         "replaces": "src/repro/kernels/kv_snapshot.py:123",
         "path": "family" if tag else "engine",
         "max_abs_err": 0.0, "ms": median_ms(capture),
         "plain_ms": median_ms(plain_capture),
         "bound_ms": bound_s * 1e3, "bound_by": bound_by,
         "library_ms": median_ms(lib_capture), "library": lib_name},
        {"name": "snapshot_restore" + suffix, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kv_snapshot.cu",
         "replaces": "src/repro/kernels/kv_snapshot.py:160",
         "path": "family" if tag else "engine",
         "max_abs_err": 0.0, "ms": median_ms(restore),
         "plain_ms": median_ms(plain_restore),
         "bound_ms": bound_s * 1e3, "bound_by": bound_by,
         "library_ms": median_ms(lib_restore),
         "library": "torch._foreach_copy_"},
    ]
    if not tag:
        # the kernel with its row ids copied to the card synchronously, as
        # the wrapper did before it staged them through pinned memory: the
        # host's work after that copy lands inside the events
        sync_rows = lambda: kv_snapshot.snapshot_capture(  # noqa: E731
            ops.load(), leaves,
            torch.tensor(rows, dtype=torch.int32, device=DEV),
            layout=layout)
        check(torch.equal(bits(sync_rows()), bits(blob)),
              "capture with synchronously copied rows equals the blob")
        out[0]["ms_sync_staged_rows"] = median_ms(sync_rows)
    unit, desc = kv_snapshot.copy_plan(leaves, blob, layout)
    for row in out:
        emit({"phase": "kernel", "config": cfg.name, **_cut(cfg), "rows": 1,
              "row_bytes": row_bytes, "bytes": nbytes, "leaves": [
                  list(x.shape) for x in leaves], "batch_axes": axes,
              "copy_unit": unit, "slice_bytes": [d * unit
                                                 for d in desc[2::4]],
              "checked_rows": list(errs), **row})
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


def _restores(eng, rid: str) -> tuple[int, int]:
    """Run invocation ``rid`` on ``eng``; its restores' remaps and
    host->device bytes, from their ``restore`` events."""
    n = len(eng.events)
    _run_one(eng, rid)
    evs = [e for e in eng.events[n:] if e.kind == "restore"]
    return (sum(e.detail["remap"] for e in evs),
            sum(e.detail["h2d_bytes"] for e in evs))


def _snapshot_events(engines) -> tuple[int, int]:
    """Snapshot captures and restores the engines' events record."""
    kinds = [e.kind for eng in engines for e in eng.events]
    return kinds.count("snapshot"), kinds.count("restore")


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
    remaps, remap_h2d = _restores(cow_a, "r0")
    fresh_remaps, fresh_h2d = _restores(cow_b, "r1")
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
    captures, restores = _snapshot_events(engines)

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
        "decode_qkv_rope launches == decode steps x layers":
            launches["decode_qkv_rope"] == decode_steps * cfg.num_layers,
        "capture launches == snapshot events": launches["snapshot_capture"]
        == captures > 0,
        "restore launches == restore events": launches["snapshot_restore"]
        == restores > 0,
        "zero-h2d remap restore": remaps == 1 and remap_h2d == 0
        and cow_ev[-1].detail["pages_shared"]
        == cow_ev[-1].detail["pages_total"],
        "fresh replica pays one h2d": cow_b.restore_starts == 1
        and fresh_remaps == 0 and fresh_h2d == row_bytes,
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
          "unplug_memory": drops,
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


@contextlib.contextmanager
def _no_collection():
    """No garbage collection inside a measured drop of device memory: an
    earlier run's replicas and broker hold each other, and a collection
    there would count their arenas as freed by the unplug measured."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


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
        self.captures = 0
        self.restores: list[dict] = []

    def watch(self, eng) -> None:
        unplug, offer, restore = (eng._unplug_now, eng._offer_snapshot,
                                  eng._start_restore)

        def measured_unplug(units, *, stolen=False):
            if not stolen:
                return unplug(units)
            before = self._survivors(eng)
            with _no_collection():
                mem0, asked = _allocated(), _requested()
                ev = unplug(units, stolen=True)
                freed, freed_asked = mem0 - _allocated(), asked - _requested()
            self.steals.append({
                "victim": eng.replica_id, "mode": eng.mode,
                "units": ev.reclaimed_units,
                "reclaimed_bytes": ev.reclaimed_bytes,
                "migrated_blocks": ev.migrated_blocks,
                "freed_bytes": freed, "freed_requested_bytes": freed_asked,
                "leaves": len(M.cache_flat_axes(eng.caches)[0])
                if eng.mode == "hotmem" else len(eng.pool),
                "survivors": eng._rows() if eng.mode == "hotmem"
                else len(before),
                "survivors_unchanged": self._unchanged(eng, before)})
            return ev

        def checked_offer(prof_name, rid, row):
            ok = offer(prof_name, rid, row)
            if ok:
                self.captures += 1
                snap = eng.broker.snapshots.peek(prof_name)
                digest = _digest(
                    snap.payload.blob if snap.pages is None else
                    assemble_pages(eng.broker.snapshot_page_specs(prof_name)))
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
            "requested bytes drop == stolen bytes; memory_allocated() "
            "within 1 MiB of block slack per leaf": all(
                s["freed_requested_bytes"] == s["reclaimed_bytes"]
                == s["units"] * (spec.bytes_per_partition
                                 if s["mode"] == "hotmem"
                                 else spec.bytes_per_block)
                and abs(s["freed_bytes"] - s["reclaimed_bytes"])
                < s["leaves"] * (1 << 20) for s in steals),
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
        "capture and restore launches == captures and restores":
            launches["snapshot_capture"] == probe.captures > 0
            and launches["snapshot_restore"] == len(probe.restores) > 0,
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
                                 "freed_requested_bytes", "reclaimed_bytes",
                                 "migrated_blocks", "survivors")}
              for s in probe.steals]
    emit({"phase": "cluster", "seconds": seconds, "launches": launches,
          "checks": checks,
          "scripted": {m: {k: r[k] for k in (
              "steals", "stolen_units", "by_mode", "kv_compact_launches",
              "completed", "killed", "decode_steps", "natural_fills")}
              for m, r in scripted.items()},
          "runs": table, "restores": probe.restores,
          "steal_memory": memory[:8], "steals_checked": len(memory),
          "steal_memory_off": [
              dict(m, n=i) for i, m in enumerate(memory)
              if m["freed_bytes"] != m["reclaimed_bytes"]][:8]})
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
# Phase 5: the other decoder families — full-width mamba2-780m,
# recurrentgemma-2b, gemma2-9b and mixtral-8x7b (16 of 32 layers) through
# the hotmem engine, one after the other; qwen2-vl-72b (8 of 80 layers) at
# the model level
# ---------------------------------------------------------------------------

# bytes of one 2048-token row, at the depth the model runs here
FAMILIES = {"mamba2-780m": 38_707_200, "recurrentgemma-2b": 17_145_856,
            "gemma2-9b": 704_643_072, "mixtral-8x7b": 134_217_728}
VLM = "qwen2-vl-72b"
# depth cuts: the whole model's bf16 weights do not fit one 80 GB card
# (mixtral 93.4 GB at 32 layers, qwen2-vl 145 GB at 80); widths are kept
DEPTH = {"mixtral-8x7b": 16, VLM: 8}
# decode against the train forward: (tokens, rows, cache length) where
# not (256, 1, PARTITION_TOKENS).  gemma2's forward at FLASH_SEQ tokens
# takes the chunked attention path (its prefill of one token less does
# not).  mixtral compares row 0 of four: a 4 x 256 batch gives each expert
# a capacity of 320 slots and row 0's 256 tokens put at most one slot each
# in an expert, so none of row 0 is dropped in the forward or the prefill
# (the other rows' drops are the reference's rule and are counted), and
# its decode computes the same function
DECODE_VS_FORWARD = {"gemma2-9b": (attn_mod.FLASH_SEQ, 1, attn_mod.FLASH_SEQ),
                     "mixtral-8x7b": (256, 4, PARTITION_TOKENS)}
TOL_MOE = 8e-2      # the reference's MoE bound (test_decode_consistency.py)


def family_config(arch: str):
    """The published config, cut in depth where its weights do not fit."""
    cfg = get_config(arch)
    if arch in DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=DEPTH[arch])
    return cfg


def _cut(cfg) -> dict:
    """The ``reduced`` field of a model's lines: its depth cut, if any."""
    full = get_config(cfg.name)
    if cfg.num_layers == full.num_layers:
        return {}
    return {"reduced": {"num_layers": [full.num_layers, cfg.num_layers]}}


def _attention_layers(cfg) -> int:
    if cfg.family == "audio":        # one self-attention per decoder block
        return cfg.num_layers
    return sum(k in transformer.ATTN_KINDS
               for k in cfg.block_pattern) * cfg.n_groups \
        + sum(k in transformer.ATTN_KINDS for k in cfg.tail_pattern)


def _tol(cfg) -> float:
    return TOL_MOE if cfg.num_experts else 5e-2


class _Spy:
    """Counts ``_chunked_attention`` calls and, on an MoE model, the
    (token, expert) slots dropped over capacity, per row and token, while
    it is entered; puts both functions back on exit."""

    def __init__(self, cfg):
        self.cfg, self.chunked, self.dropped = cfg, 0, []

    def __enter__(self):
        self._chunked, self._moe = attn_mod._chunked_attention, \
            moe_mod.moe_block

        def chunked(*a):
            self.chunked += 1
            return self._chunked(*a)

        def moe_block(cfg, p, x):
            xt = x.reshape(-1, x.shape[-1])
            _w, top_e = moe_mod.route(cfg, p, xt)
            _e, _r, keep = moe_mod.dispatch_slots(
                cfg, top_e, moe_mod.capacity(cfg, xt.shape[0]))
            self.dropped.append((~keep).view(x.shape[0], x.shape[1], -1)
                                .sum(-1))
            return self._moe(cfg, p, x)
        attn_mod._chunked_attention, moe_mod.moe_block = chunked, moe_block
        return self

    def __exit__(self, *exc):
        attn_mod._chunked_attention, moe_mod.moe_block = self._chunked, \
            self._moe

    def drops(self) -> torch.Tensor:
        """Dropped slots per (row, token), summed over the layers."""
        return sum(self.dropped) if self.dropped else torch.zeros(1)


def _decode_vs_forward(cfg, params, n=256, rows=1,
                       cache_len=PARTITION_TOKENS, extra=None) -> dict:
    """Prefill n - 1 tokens, decode token n - 1, against the train forward
    on all n (one SSD chunk at 256): relative error of row 0's last logits,
    under 5e-2 as in ``tests/test_decode_consistency.py`` (MoE: 8e-2, the
    same file's bound).  ``extra`` adds to both batches (the vision stub;
    positions, cut to n - 1 for the prefill).  Random tokens, seed 1."""
    g = torch.Generator(device=DEV)
    g.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (rows, n), generator=g,
                         device=DEV, dtype=torch.int32)
    extra = extra or {}
    pre = {k: v[..., :n - 1] if k == "positions" else v
           for k, v in extra.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Spy(cfg) as fwd:
        full = M.forward_train(cfg, params, {"tokens": toks, **extra})[
            0, n - 1].float()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    caches = M.init_caches(cfg, rows, cache_len, device=DEV)
    with _Spy(cfg) as pf:
        _, caches = M.prefill(cfg, params, {"tokens": toks[:, :n - 1],
                                            **pre}, caches)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    lg, _ = M.decode_step(cfg, params, toks[:, n - 1:],
                          torch.full((rows,), n - 1, dtype=torch.int32,
                                     device=DEV), caches)
    lg = lg[0].float()
    err = float((full - lg).abs().max()) / float(full.abs().max())
    tol = _tol(cfg)
    check(tuple(lg.shape) == tuple(full.shape)
          and bool(torch.isfinite(lg).all()) and err < tol,
          f"{cfg.name}: decode vs forward relative error {err} < {tol}")
    flash = n >= attn_mod.FLASH_SEQ
    check(fwd.chunked == (_attention_layers(cfg) if flash else 0)
          and pf.chunked == 0,
          f"{cfg.name}: the forward on {n} tokens took the chunked path in "
          f"{fwd.chunked} layers, the prefill in {pf.chunked}")
    out = {"tokens": n, "rows": rows, "cache_len": cache_len,
           "decode_vs_forward_rel_err": err, "tolerance": tol,
           "forward_s": t1 - t0, "prefill_s": t2 - t1,
           "chunked_layers_forward": fwd.chunked}
    if cfg.num_experts:
        drops = fwd.drops()
        check(not drops[0].any() and not pf.drops()[0].any(),
              f"{cfg.name}: no slot of row 0 dropped in the forward or the "
              f"prefill")
        out.update(dropped_slots_forward=int(drops.sum()),
                   dropped_slots_row0=int(drops[0].sum()),
                   slots_forward=len(fwd.dropped) * rows * n
                   * cfg.num_experts_per_tok)
    return out


def phase_chunked(cfg, gen) -> dict:
    """``_chunked_attention`` against ``_plain_attention`` at one layer's
    full shapes (S = FLASH_SEQ tokens of one row, the model's heads, head
    dim, logit cap and query scale; q scaled by 8 so the cap bends the
    scores), for each window of its blocks, and the time of each (median
    of 5 behind the L2 flush)."""
    s, hkv, dh = attn_mod.FLASH_SEQ, cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // hkv
    scale = cfg.query_scale or dh ** -0.5
    cap = cfg.attn_logit_softcap
    bf16 = torch.bfloat16
    q = randn((1, s, hkv, g, dh), bf16, gen) * 8
    k = randn((1, s, hkv, dh), bf16, gen)
    v = randn((1, s, hkv, dh), bf16, gen)
    pos = torch.arange(s, dtype=torch.int32, device=DEV)[None]
    out = {"shape": [1, s, hkv, g, dh], "logit_cap": cap, "scale": scale,
           "q_chunk": attn_mod.Q_CHUNK, "kv_chunk": attn_mod.KV_CHUNK}
    for w in _attention_windows(cfg):
        args = (q, k, v, pos, pos, w, scale, cap)
        ok, err, limit = attention_close(attn_mod._chunked_attention(*args),
                                         attn_mod._plain_attention(*args))
        check(ok, f"{cfg.name}: chunked vs plain attention, window {w}: "
                  f"error {err} within {TOL_BF16} and {limit}")
        out[f"window_{w}"] = {
            "max_abs_err": err, "tight_limit": limit,
            "chunked_ms": median_ms(partial(attn_mod._chunked_attention,
                                            *args), runs=5),
            "plain_ms": median_ms(partial(attn_mod._plain_attention, *args),
                                  runs=5)}
    emit({"phase": "chunked_attention", "config": cfg.name, **out})
    return out


def _requested() -> int:
    """Bytes the live tensors asked the caching allocator for.  Unlike
    ``memory_allocated()`` this is not rounded to the allocator's blocks:
    a request served from a cached block less than 1 MB larger takes the
    whole block, so one unplug's ``memory_allocated()`` drop can be off by
    that slack (and the next one off by as much the other way)."""
    torch.cuda.synchronize(DEV)
    return torch.cuda.memory_stats(DEV)["requested_bytes.all.current"]


def _watch_unplugs(eng, drops: list) -> None:
    """Record ``memory_allocated()`` and the requested bytes around each
    row sync that drops rows (an unplug), with the bytes the dropped rows
    held."""
    sync_rows = eng._sync_rows

    def measured(parts):
        rows = eng._rows()
        with _no_collection():
            before, asked = _allocated(), _requested()
            sync_rows(parts)
            freed, freed_asked = before - _allocated(), asked - _requested()
        if parts < rows:
            drops.append({"replica": eng.replica_id, "rows": rows,
                          "parts": parts,
                          "freed_bytes": freed,
                          "freed_requested_bytes": freed_asked,
                          "row_bytes": (rows - parts)
                          * eng.spec.bytes_per_partition})
    eng._sync_rows = measured


def _family_engines(cfg, params, gen) -> tuple[dict, dict]:
    """The hotmem schedules on one model: (a) cold, warm, capture,
    restore, restore; (b) paged copy-on-write with 2 MiB pages, a local
    remap and a fresh replica; (c) the bursty trace up and down the
    ladder.  Every engine is made inside the counted run, so each one's
    warm-up decode step counts.  The recurrent families must refuse the
    vanilla engine, as the reference does."""
    spec = ArenaSpec.from_model(cfg, partition_tokens=PARTITION_TOKENS,
                                n_partitions=N_PARTITIONS,
                                block_tokens=BLOCK_TOKENS)
    check(spec.bytes_per_partition == FAMILIES[cfg.name],
          f"{cfg.name}: bytes per partition {spec.bytes_per_partition}")
    refused = ""
    if cfg.family in ("ssm", "hybrid"):
        try:
            ServeEngine(cfg, params, spec, mode="vanilla")
        except AssertionError as e:
            refused = str(e)
        check("token-extensive" in refused,
              f"{cfg.name}: the vanilla engine is refused ({refused!r})")
    bpp = spec.blocks_per_partition
    probe = ClusterProbe(spec, gen)
    drops = []
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
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
    engines = (snap, cow_a, cow_b, burst)
    for eng in engines:
        probe.watch(eng)
        _watch_unplugs(eng, drops)
    _run_one(snap, "c0")
    _run_one(snap, "w0")
    _expire(snap)
    _run_one(snap, "s0")
    _expire(snap)
    _run_one(snap, "s1")
    m_snap = snap.metrics()
    _run_one(cow_a, "c0")
    _expire(cow_a)
    remaps, remap_h2d = _restores(cow_a, "r0")
    fresh_remaps, fresh_h2d = _restores(cow_b, "r1")
    reqs = _bursty()
    m_burst = burst.run(reqs, max_virtual_s=2000)
    torch.cuda.synchronize(DEV)
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    n_leaves = len(M.cache_flat_axes(burst.caches)[0])
    metrics = [e.metrics() for e in engines]
    decode_steps = sum(m["decode_steps"] for m in metrics)
    captures = sum(m["snapshots_taken"] for m in metrics)
    restores = sum(m["restore_starts"] for m in metrics)
    attn_layers = _attention_layers(cfg)
    cow_ev = [e for e in cow_a.events if e.kind == "restore"]
    pages = -(-FAMILIES[cfg.name] // PAGE_BYTES)
    row_bytes = kv_snapshot.expected_row_bytes(cfg, PARTITION_TOKENS)
    snap_ev = [e for e in snap.events if e.kind == "snapshot"]
    checks = {
        "completed == submitted, killed == 0":
            m_burst["completed"] == len(reqs)
            and all(m["killed"] == 0 for m in metrics)
            and all(not e.active and not e.pending for e in engines),
        "migrated_bytes == 0": all(m["migrated_bytes"] == 0
                                   for m in metrics),
        "reclaimed_bytes > 0, plugged and unplugged":
            m_burst["reclaimed_bytes"] > 0
            and {"plug", "unplug"} <= {e.kind for e in burst.events},
        "requested bytes drop == dropped rows' bytes at every unplug; "
        "memory_allocated() within 1 MiB of block slack per leaf":
            bool(drops) and all(
                d["freed_requested_bytes"] == d["row_bytes"]
                and abs(d["freed_bytes"] - d["row_bytes"])
                < n_leaves * (1 << 20) for d in drops),
        "cold, warm, restore starts": (m_snap["cold_starts"],
                                       m_snap["warm_starts"]) == (1, 1)
        and m_snap["restore_starts"] >= 2,
        "captured bytes == expected_row_bytes":
            m_snap["snapshots_taken"] == 1
            and snap_ev[0].detail["bytes"] == row_bytes,
        "every restored row equals its captured blob (sha256)":
            len(probe.restores) == restores >= 4
            and all(r["equal"] for r in probe.restores),
        "zero-h2d remap restore": remaps == 1 and remap_h2d == 0
        and cow_ev[-1].detail["pages_shared"]
        == cow_ev[-1].detail["pages_total"] == pages,
        "fresh replica pays one h2d": cow_b.restore_starts == 1
        and fresh_remaps == 0 and fresh_h2d == row_bytes,
        "partition_attention launches == (decode steps + warm-ups) x "
        "attention layers": launches["partition_attention"]
        == (decode_steps + len(engines)) * attn_layers,
        "capture launches == captures":
            launches["snapshot_capture"] == captures > 0,
        "restore launches == restores":
            launches["snapshot_restore"] == restores > 0,
        "no kv_compact or paged_attention launch":
            launches["kv_compact"] == launches["paged_attention"] == 0,
    }
    walls = {k: [e.wall_s * 1e3 for e in burst.events if e.kind == k]
             for k in ("decode", "prefill", "plug", "unplug")}
    for k in ("snapshot", "restore"):
        walls[k] = [e.wall_s * 1e3 for eng in (snap, cow_a, cow_b)
                    for e in eng.events if e.kind == k]
    wall_stats = {k: {"n": len(v), "median": float(np.median(v)),
                      "min": min(v), "max": max(v)}
                  for k, v in walls.items() if v}
    emit({"phase": "family_engine", "config": cfg.name, **_cut(cfg),
          "run_seconds": run_s, "bytes_per_partition":
          spec.bytes_per_partition, "pages_per_row": pages,
          "attention_layers": attn_layers, "decode_steps": decode_steps,
          "engines": len(engines), "launches": launches,
          "unplug_memory": drops, "restores": probe.restores,
          "walls_ms": {k: v for k, v in walls.items() if k != "decode"},
          "wall_stats_ms": wall_stats,
          "burst": {k: v for k, v in m_burst.items() if k != "events"},
          "snapshot_schedule": {k: v for k, v in m_snap.items()
                                if k != "events"},
          "vanilla_refused": refused, "checks": checks})
    for what, ok in checks.items():
        check(ok, f"{cfg.name}: {what}")
    summary = {"run_seconds": run_s,
               "wall_median_ms": {k: v["median"]
                                  for k, v in wall_stats.items()},
               "reclaimed_bytes": m_burst["reclaimed_bytes"],
               "unplug_freed_bytes": [d["freed_bytes"] for d in drops],
               "latency_p50_s": m_burst["latency_p50"],
               "latency_p99_s": m_burst["latency_p99"]}
    return launches, summary


def phase_family(arch, gen) -> tuple[list[dict], dict]:
    """One model at full width (cut in depth where it does not fit), then
    freed: (a) the snapshot kernels over its cache tree and, where it has
    attention blocks, ``partition_attention`` at its shapes (and, for a
    model whose checks prefill FLASH_SEQ tokens, the chunked attention at
    one layer's shapes); (b) decode against the train forward; (c) the
    hotmem engine's schedules; (d) where a decode step's time goes."""
    cfg = family_config(arch)
    t0 = time.perf_counter()
    rows = phase_snapshot(cfg, gen, tag=arch)
    if _attention_layers(cfg):
        rows.append(phase_attention_at(cfg, gen, arch))
    n, n_rows, cache_len = DECODE_VS_FORWARD.get(arch, (256, 1,
                                                        PARTITION_TOKENS))
    chunked = phase_chunked(cfg, gen) if n >= attn_mod.FLASH_SEQ else None
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init_params(cfg, 0, device=DEV)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(),
          f"{arch}: {n_params} parameters, the spec says "
          f"{cfg.param_count()}")
    model = _decode_vs_forward(cfg, params, n, n_rows, cache_len)
    emit({"phase": "family_model", "config": arch, **_cut(cfg),
          "params": n_params, "param_bytes": sum(
              x.numel() * x.element_size() for x in tree_leaves(params)),
          **model})
    launches, summary = _family_engines(cfg, params, gen)
    for row in rows:
        row["launches"] = launches[row["name"].split("@")[0]]
    summary.update(phase_profile(cfg, params))
    summary["model"] = model
    if chunked:
        summary["chunked_attention"] = chunked
    summary["seconds"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rows, summary


def _vision_inputs(cfg, rows: int, n: int, device):
    """Stub patch embeddings for the first ``vision_stub_tokens`` tokens
    (random, seed 1, drawn on the CPU so that every device gets the same)
    and M-RoPE positions (3, rows, n): section 0 is the token index (the
    mask and the cache slot read it); for the patches, sections 1 and 2
    are the row and the column of a square grid; for the text tokens all
    three are the index, as decode's (B,) positions broadcast to (3, B)."""
    patches = cfg.vision_stub_tokens
    side = int(patches ** 0.5)
    check(side * side == patches, f"{patches} patches make a square grid")
    g = torch.Generator()
    g.manual_seed(1)
    vis = torch.randn((rows, patches, cfg.d_model), generator=g).to(
        torch.bfloat16)
    pos = torch.arange(n, dtype=torch.int32).expand(3, rows, n).clone()
    grid = torch.arange(patches, dtype=torch.int32)
    pos[1, :, :patches] = grid // side
    pos[2, :, :patches] = grid % side
    return vis.to(device), pos.to(device)


def phase_vlm() -> dict:
    """qwen2-vl-72b at full width, 8 of 80 layers, at the model level (the
    engine passes no vision input, so its engine path is qwen2's with
    biases): 512 tokens whose first ``vision_stub_tokens`` (256) are stub
    patch embeddings with M-RoPE positions on a 16 x 16 grid
    (``_vision_inputs``).  Decode of token 511 against the train forward,
    under 5e-2."""
    cfg = family_config(VLM)
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device=DEV)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(),
          f"{VLM}: {n_params} parameters, the spec says "
          f"{cfg.param_count()}")
    n = 512
    vis, pos = _vision_inputs(cfg, 1, n, DEV)
    model = _decode_vs_forward(cfg, params, n,
                               extra={"vision_embeds": vis,
                                      "positions": pos})
    side = int(cfg.vision_stub_tokens ** 0.5)
    emit({"phase": "family_model", "config": VLM, **_cut(cfg),
          "params": n_params, "param_bytes": sum(
              x.numel() * x.element_size() for x in tree_leaves(params)),
          "vision_stub_tokens": cfg.vision_stub_tokens, "mrope_sections":
          list(cfg.mrope_sections), "patch_grid": [side, side], **model})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {**model, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 5b: training (full-width tinyllama-1.1b) and the encoder-decoder
# family (full-width seamless-m4t-medium, at the model level)
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "tinyllama-1.1b", 8, 1024
# memorising one batch with warmup 1: ``tests/test_training.py``'s lr 3e-3
# suits its reduced widths.  On 1.1 B parameters Adam's un-warmed first
# steps move every weight by about the rate in the sign of its gradient,
# which changes the loss by far more than its value: on the card the loss
# rose over 6 steps at 3e-3 and ended barely below its start at 3e-4 (the
# reference's default rate), with spikes at every rate tried.  Both are
# run and reported; the check runs at TRAIN_LR.
TRAIN_LR, REPORTED_LRS = 3e-5, (3e-3, 3e-4)
AUDIO = "seamless-m4t-medium"


def _run_steps(step_fn, state, batch, n: int):
    """``n`` steps on one batch: per step the loss, the grad norm and the
    host wall (each step ends by reading the loss, which waits for the
    card)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = scalar(m["loss"])
        out.append((loss, scalar(m["grad_norm"]), time.perf_counter() - t0))
    return state, out


def _peak_bytes(step_fn, state, batch):
    """``max_memory_allocated`` over one step, the state held throughout."""
    torch.cuda.synchronize(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    state, m = step_fn(state, batch)
    scalar(m["loss"])
    return state, torch.cuda.max_memory_allocated(DEV)


def _crash_resume() -> dict:
    """``tests/test_checkpoint.py``'s crash and resume on the card, through
    ``launch/train.py``: reduced qwen2-1.5b, 12 steps of 2 x 16 tokens,
    a checkpoint every 4 steps into a temporary directory, a crash injected
    at step 8; the newest complete checkpoint must be step 4 or 8 (the
    step-8 save is async), and the resumed run's params must equal a clean
    run's within 1e-2.  A full-width checkpoint would be 15.4 GB of npz."""
    kw = dict(steps=12, batch=2, seq=16, log_every=100, device=DEV)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ck = str(Path(d) / "ck")
        try:
            train("qwen2-1.5b", ckpt_dir=ck, ckpt_every=4, fail_at_step=8,
                  **kw)
        except RuntimeError as e:         # the injected crash, and only it
            if "injected failure at step 8" not in str(e):
                raise
        else:
            check(False, "the run with a failure injected at step 8 crashed")
        last = ckpt.latest(ck)
        check(last in (4, 8), f"newest complete checkpoint {last} is 4 or 8")
        resumed, _ = train("qwen2-1.5b", ckpt_dir=ck, ckpt_every=4,
                           resume=True, **kw)
        clean, _ = train("qwen2-1.5b", ckpt_dir=str(Path(d) / "clean"),
                         ckpt_every=100, **kw)
    errs = [allclose(a, b, 1e-2) for a, b in zip(
        tree_leaves(resumed["params"]), tree_leaves(clean["params"]),
        strict=True)]
    check(all(ok for ok, _ in errs) and int(resumed["opt"]["step"]) == 12,
          "the resumed run's params equal the clean run's within 1e-2")
    return {"latest_after_crash": last,
            "max_abs_err_vs_clean": max(e for _, e in errs),
            "seconds": time.perf_counter() - t0}


def _train_run(cfg, state, batch, lrs, mesh=None, rules=None):
    """``phase_train``'s run, on ``mesh`` under ``rules`` when given:
    grad accumulation 2 against 1 on the same params and batch, then
    memorising ``batch`` in 6 steps with warmup 1 from the same start at
    each of ``lrs`` (the last is the run that is measured and checked),
    its step profiled; the peak memory is that of the last run, with the
    state, the batch and nothing else held.  A step updates ``state`` in
    place, and the dict it returns is dropped: the caller holds ``state``
    too, so an optimizer state that a second dict held would stay alive.
    Returns (state, figures)."""
    start = [x.clone() for x in tree_leaves(state["params"])]

    def rewind():
        for x, x0 in zip(tree_leaves(state["params"]), start):
            x.copy_(x0)

    with sharding_ctx(mesh, rules or {}):
        accum = {}
        for a in (1, 2):
            rewind()
            m = make_train_step(cfg, grad_accum=a)(state, batch)[1]
            accum[a] = {"loss": scalar(m["loss"]),
                        "grad_norm": scalar(m["grad_norm"])}
        memorise = {}
        for i, lr in enumerate(lrs):
            rewind()
            if i == len(lrs) - 1:
                start.clear()
            state["opt"] = None
            gc.collect()
            state["opt"] = init_opt_state(state["params"])
            step_fn = make_train_step(cfg, AdamWConfig(lr=lr,
                                                       warmup_steps=1))
            torch.cuda.synchronize(DEV)
            torch.cuda.reset_peak_memory_stats(DEV)
            memorise[lr] = _run_steps(step_fn, state, batch, 6)[1]
        peak = torch.cuda.max_memory_allocated(DEV)
        n_prof = 2
        kernels, prof_wall = _device_kernels(lambda: step_fn(state, batch),
                                             n_prof)
    steps = memorise[lrs[-1]]
    wall = float(np.median([x[2] for x in steps[1:]]))
    busy_us = sum(k[0] for k in kernels)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6.0 * sum(x.numel() for x in tree_leaves(state["params"])) \
        * tokens
    return state, {
        "grad_accum": accum,
        "grad_accum_loss_diff": abs(accum[1]["loss"] - accum[2]["loss"]),
        "grad_accum_grad_norm_rel_diff":
            abs(accum[1]["grad_norm"] - accum[2]["grad_norm"])
            / (accum[1]["grad_norm"] + 1e-9),
        "lr": lrs[-1], "losses": [x[0] for x in steps],
        "grad_norms": [x[1] for x in steps],
        "reported": {str(lr): {"losses": [x[0] for x in memorise[lr]],
                               "grad_norms": [x[1] for x in memorise[lr]]}
                     for lr in lrs[:-1]},
        "first_step_ms": steps[0][2] * 1e3,
        "step_walls_ms": [x[2] * 1e3 for x in steps],
        "step_ms_median": wall * 1e3,
        "device_busy_ms_per_step": busy_us / n_prof / 1e3,
        "device_busy_share": busy_us / 1e6 / prof_wall,
        "tokens_per_s": tokens / wall,
        "model_flops_per_step": flops,
        "peak_bf16_share": flops / wall / roofline.PEAK_BF16,
        "peak_bytes": peak,
        "top": [{"kernel": k[2][:90], "ms_per_step": k[0] / n_prof / 1e3,
                 "launches_per_step": k[1] / n_prof,
                 "share": k[0] / busy_us} for k in kernels[:8]]}


def _check_train_run(run: dict, tag: str) -> bool:
    """The bounds of ``tests/test_training.py``'s grad accumulation check
    and a memorising run whose loss falls."""
    accum_ok = run["grad_accum_loss_diff"] < 2e-2 \
        and run["grad_accum_grad_norm_rel_diff"] < 5e-2
    check(accum_ok, f"{tag}grad_accum 2 vs 1: loss "
          f"{run['grad_accum_loss_diff']} < 2e-2, grad norm "
          f"{run['grad_accum_grad_norm_rel_diff']} < 5e-2 relative")
    losses, norms = run["losses"], run["grad_norms"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0]
          and all(g > 0 for g in norms),
          f"{tag}{TRAIN_ARCH} memorises a fixed batch at lr {run['lr']}: "
          f"losses {losses}, grad norms {norms}")
    return accum_ok


def phase_train() -> dict:
    """Full-width tinyllama-1.1b (random bf16 weights from seed 0, f32
    AdamW state) through ``launch/train.py``'s step on batches of 8 x 1024
    tokens (``make_batch``): grad accumulation 2 against 1 on the same
    params and batch (``tests/test_training.py``'s bounds); memorising one
    fixed batch in 6 steps with warmup 1 from the same start, at
    ``REPORTED_LRS`` (reported) and at ``TRAIN_LR`` (the loss must fall);
    the step's wall, its device time from ``torch.profiler``, tokens/s and
    the share 6 N tokens / wall / ``roofline.PEAK_BF16``; the peak memory
    of one step with and without remat at 4 x 1024 (without remat the
    attention scores of all 22 layers are kept: 8 x 1024 would come near
    the card's 80 GB); then the crash and resume."""
    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device=DEV)
    state = {"params": params, "opt": init_opt_state(params)}
    del params
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    check(n_params == cfg.param_count(),
          f"{TRAIN_ARCH}: {n_params} parameters, the spec says "
          f"{cfg.param_count()}")
    state_bytes = {k: sum(x.numel() * x.element_size()
                          for x in tree_leaves(v))
                   for k, v in (("params", state["params"]),
                                *((n, state["opt"][n])
                                  for n in ("master", "m", "v")))}
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                      TRAIN_BATCH))
    batch = make_batch(cfg, data, 0, DEV)
    state, run = _train_run(cfg, state, batch, (*REPORTED_LRS, TRAIN_LR))
    _check_train_run(run, "")

    small = {k: v[:TRAIN_BATCH // 2] for k, v in batch.items()}
    peak = {}
    for remat in (True, False):
        state, peak[remat] = _peak_bytes(
            make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1),
                            remat=remat), state, small)
    check(peak[True] < peak[False],
          f"remat lowers the peak memory: {peak[True]} < {peak[False]}")
    del state, batch, small
    gc.collect()
    torch.cuda.empty_cache()
    resume = _crash_resume()
    top = run.pop("top")
    out = {"config": TRAIN_ARCH, "params": n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "remat": True, "state_bytes": state_bytes,
           **run, "peak_bytes_4x1024": {"remat": peak[True],
                                        "no_remat": peak[False]},
           "crash_resume": resume,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "train", **out, "top": top})
    return out


# ---------------------------------------------------------------------------
# The mesh phase: the sharding layer on a world of one
# ---------------------------------------------------------------------------

MESH_MOE_ARCH, MESH_MOE_ROWS, MESH_MOE_SEQ = "mixtral-8x7b", 4, 256
MESH_LOSS_TOL = 2e-2


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _mesh_train(mesh, checks: dict, plain: dict) -> tuple[dict, dict]:
    """``phase_train``'s run on the mesh: full-width tinyllama-1.1b under
    ``train_rules_for`` (DP-only: batch and weights over every axis),
    params, master, m and v DTensors on the mesh, the batch on ("batch",
    "seq"); grad accumulation 2 against 1, then memorising the same batch
    at ``TRAIN_LR`` from the same start, its losses held to
    ``phase_train``'s.  Returns (figures, state)."""
    cfg = get_config(TRAIN_ARCH)
    rules = train_rules_for(cfg)
    checks["tinyllama_trains_dp_only"] = rules is DP_ONLY_TRAIN_RULES
    params = M.init_params(cfg, 0, device=DEV, mesh=mesh, rules=rules)
    state = {"params": params, "opt": init_opt_state(params)}
    del params
    leaves = tree_leaves(state["params"]) + [
        x for k in ("master", "m", "v") for x in tree_leaves(state["opt"][k])]
    checks["every_state_leaf_a_dtensor_on_the_mesh"] = all(
        is_dtensor(x) and x.device_mesh == mesh for x in leaves)
    del leaves
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                      TRAIN_BATCH))
    batch = batch_to_mesh(make_batch(cfg, data, 0, DEV), mesh, rules)
    state, run = _train_run(cfg, state, batch, (TRAIN_LR,), mesh, rules)
    checks["grad_accum_2_vs_1"] = _check_train_run(run, "mesh: ")
    diffs = [abs(a - b) for a, b in zip(run["losses"], plain["losses"],
                                        strict=True)]
    checks["losses_equal_the_unsharded_run"] = max(diffs) < MESH_LOSS_TOL
    checks["local_shapes_are_shard_shapes"] = all(
        tuple(x.to_local().shape) == sh.shard_shape(tuple(x.shape))
        for x, sh in zip(tree_leaves(state["params"]),
                         tree_leaves(M.param_shardings(cfg, mesh, rules)),
                         strict=True))
    return {"config": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            **{k: run[k] for k in (
                "lr", "losses", "grad_accum", "grad_accum_loss_diff",
                "grad_accum_grad_norm_rel_diff", "first_step_ms",
                "step_walls_ms")},
            "losses_without_mesh": plain["losses"],
            "loss_max_abs_diff": max(diffs), "loss_tol": MESH_LOSS_TOL,
            **{f"{k}{sfx}": src[k] for k in (
                "step_ms_median", "device_busy_ms_per_step",
                "device_busy_share", "tokens_per_s", "peak_bytes")
               for sfx, src in (("", run), ("_without_mesh", plain))}}, \
        state


def _mesh_reshard(mesh, state, checks: dict) -> dict:
    """The mesh run's params saved asynchronously (a full-width train
    state would be 15.4 GB of npz; the params are 2.2 GB), restored onto
    the mesh's placements and onto no mesh: both bit-equal to the saved
    leaves."""
    cfg = get_config(TRAIN_ARCH)
    saved = {"params": state["params"]}
    target = {"params": state_shardings(cfg, mesh,
                                        train_rules_for(cfg))["params"]}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 6, saved, blocking=False).join()
        t_save = time.perf_counter() - t0
        on_mesh = ckpt.restore(d, 6, saved, placements=target)
        plain = ckpt.restore(d, 6, saved, device=DEV)
    want = tree_leaves(saved["params"])
    checks["restored_onto_the_mesh_bit_equal"] = all(
        is_dtensor(x) and x.placements == sh.placements
        and torch.equal(x.to_local(), w.to_local())
        for x, w, sh in zip(tree_leaves(on_mesh["params"]), want,
                            tree_leaves(target["params"]), strict=True))
    checks["restored_onto_no_mesh_bit_equal"] = all(
        not is_dtensor(x) and torch.equal(x, w.full_tensor())
        for x, w in zip(tree_leaves(plain["params"]), want, strict=True))
    return {"saved": "params", "bytes": sum(x.numel() * x.element_size()
                                            for x in want),
            "save_s": t_save, "seconds": time.perf_counter() - t0}


def _mesh_moe(mesh, gen, checks: dict) -> dict:
    """One full-width mixtral-8x7b MoE layer (8 experts of d_ff 14336,
    2.8 GB of bf16 expert weights) under ``train_rules_for`` (the ``tp``
    override): 4 x 256 tokens through ``_moe_shard_map`` on the mesh and
    through ``_moe_dense``, routing equal, outputs within 8e-2 of the
    largest, both timed."""
    cfg = get_config(MESH_MOE_ARCH)
    rules = train_rules_for(cfg)
    p = materialize(moe_mod.moe_spec(cfg), 0, device=DEV, mesh=mesh,
                    rules=rules)
    plain = {k: v.full_tensor() for k, v in p.items()}
    shape = (MESH_MOE_ROWS, MESH_MOE_SEQ, cfg.d_model)
    x = randn(shape, torch.bfloat16, gen)
    xd = distribute(x, named_sharding(("batch", "seq", None), shape, mesh,
                                      rules))
    with sharding_ctx(mesh, rules):
        ctx = current_ctx()
        y_map = moe_mod._moe_shard_map(cfg, p, xd, ctx)
        ms_map = median_ms(lambda: moe_mod._moe_shard_map(cfg, p, xd, ctx))
        local_routes = moe_mod.route(cfg, {"router": p["router"].to_local()},
                                     xd.to_local().reshape(-1, cfg.d_model))
    y = moe_mod._moe_dense(cfg, plain, x)
    ms_dense = median_ms(lambda: moe_mod._moe_dense(cfg, plain, x))
    routes = moe_mod.route(cfg, plain, x.reshape(-1, cfg.d_model))
    err = float((y_map.full_tensor().float() - y.float()).abs().max()
                / y.float().abs().max())
    checks["moe_routing_equal"] = torch.equal(local_routes[1], routes[1])
    checks["moe_shard_map_matches_dense"] = err < 8e-2
    return {"config": MESH_MOE_ARCH, "tokens": MESH_MOE_ROWS * MESH_MOE_SEQ,
            "expert_bytes": sum(p[k].numel() * 2 for k in
                                ("gate", "up", "down")),
            "rel_err": err, "tol": 8e-2, "shard_map_ms": ms_map,
            "dense_ms": ms_dense}


def _mesh_cluster(checks: dict) -> dict:
    """The demo's 38-request trace on full-width qwen2-7b, hotmem under
    the sync broker, on a host whose broker keeps two device columns
    (``DeviceTopology.uniform(budget, 2)``, as ``--devices 2``)."""
    cfg, params, spec = load_model(use_reduced=False, device=DEV)
    topo = DeviceTopology.uniform(host_budget(spec, 1), 2)
    t0 = time.perf_counter()
    sched, _hosts, sim = build_cluster(cfg, params, spec, mode="hotmem",
                                       async_mode=False, topology=topo)
    m = sim.run(demo_requests(False), max_virtual_s=2000)
    sched.check_invariants()
    r = summarize("hotmem", sched, m)
    cols = sched.brokers["h0"].ledger.device_report()
    checks["sharded_host_completed_38"] = r["completed"] == 38
    checks["sharded_host_steals"] = r["steals"] > 0
    checks["sharded_host_migrated_0"] = r["migrated_bytes"] == 0
    checks["sharded_host_columns_balanced"] = len(cols) == 2 \
        and all(c == cols[0] for c in cols)
    return {"completed": r["completed"], "steals": r["steals"],
            "migrated_bytes": r["migrated_bytes"], "devices": cols,
            "seconds": time.perf_counter() - t0}


def phase_mesh(plain: dict, gen) -> dict:
    """The sharding layer on the card, a world of one: NCCL bring-up
    through ``launch/distributed.initialize`` on a loopback port, the
    (1, 1) ("data", "model") host mesh, ``phase_train``'s run on it
    (``plain`` is ``phase_train``'s figures), the reshard on load, the
    MoE shard-map path at full width, and a sharded-host cluster run.
    The process group is destroyed at the end, so later phases run as
    before.  Multi-rank sharding is proven on the CPU
    (``tests/test_torch_mesh.py``); NCCL takes one rank per card."""
    t0 = time.perf_counter()
    checks = {}
    rank, world = distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        checks["nccl_world_of_one"] = (rank, world) == (0, 1) \
            and dist.get_backend() == "nccl"
        mesh = make_host_mesh()
        checks["host_mesh_1x1"] = tuple(mesh.shape) == (1, 1) \
            and mesh.mesh_dim_names == ("data", "model")
        train_out, state = _mesh_train(mesh, checks, plain)
        reshard = _mesh_reshard(mesh, state, checks)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        moe = _mesh_moe(mesh, gen, checks)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    cluster = _mesh_cluster(checks)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"mesh": {"shape": [1, 1], "dims": ["data", "model"],
                    "backend": "nccl"},
           "train": train_out, "reshard": reshard, "moe": moe,
           "sharded_host": cluster, "checks": checks,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "mesh", **out})
    check(all(checks.values()), f"mesh checks {checks}")
    return out


def _frames(cfg, rows: int, device):
    """Stub encoder frames (rows, encoder_src_len, d_model): random, seed 1,
    drawn on the CPU so that every device gets the same."""
    g = torch.Generator()
    g.manual_seed(1)
    return torch.randn((rows, cfg.encoder_src_len, cfg.d_model),
                       generator=g).to(torch.bfloat16).to(device)


def _seamless_model(cfg, params, n: int = 256, steps: int = 16) -> dict:
    """Full-width seamless at the model level, with the launch counts set
    to 0 before the path and read after it: the encoder over 8 rows of stub
    frames and the prefill of n - 1 tokens into the self and cross caches
    of 8 rows of 2048 tokens; one row captured (``cache_read_rows``); token
    n - 1 decoded and held against the train forward over n tokens, on
    every row (under 5e-2 as in ``tests/test_decode_consistency.py``);
    ``steps`` more decode steps; the captured row restored and captured
    again, bit-exact."""
    rows = N_PARTITIONS
    g = torch.Generator(device=DEV)
    g.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (rows, n + steps), generator=g,
                         device=DEV, dtype=torch.int32)
    frames = _frames(cfg, rows, DEV)
    with torch.no_grad():
        torch.cuda.synchronize(DEV)
        t0 = time.perf_counter()
        full = M.forward_train(cfg, params, {"tokens": toks[:, :n],
                                             "frames": frames})[:, n - 1]
        full = full.float()
        torch.cuda.synchronize(DEV)
        t1 = time.perf_counter()
        caches = M.init_caches(cfg, rows, PARTITION_TOKENS, device=DEV)
        ops.reset_launches()
        torch.cuda.synchronize(DEV)
        t2 = time.perf_counter()
        _, caches = M.prefill(cfg, params, {"tokens": toks[:, :n - 1],
                                            "frames": frames}, caches)
        torch.cuda.synchronize(DEV)
        t3 = time.perf_counter()
        blob = M.cache_read_rows(caches, [3])
        walls = []
        for i in range(steps + 1):
            t = time.perf_counter()
            lg, _ = M.decode_step(cfg, params, toks[:, n - 1 + i:n + i],
                                  torch.full((rows,), n - 1 + i,
                                             dtype=torch.int32, device=DEV),
                                  caches)
            torch.cuda.synchronize(DEV)
            walls.append(time.perf_counter() - t)
            if i == 0:
                first = lg.float()
        M.cache_write_rows(caches, blob, [3])
        back = M.cache_read_rows(caches, [3])
        torch.cuda.synchronize(DEV)
        launches = dict(ops.LAUNCHES)
    err = float((full - first).abs().max()) / float(full.abs().max())
    check(tuple(first.shape) == tuple(full.shape)
          and bool(torch.isfinite(first).all()) and err < 5e-2,
          f"{AUDIO}: decode vs forward relative error {err} < 5e-2")
    check(torch.equal(back.view(torch.int16), blob.view(torch.int16)),
          f"{AUDIO}: the restored row captures back to its blob")
    check(launches["partition_attention"] == cfg.num_layers * (steps + 1)
          and launches["snapshot_capture"] == 2
          and launches["snapshot_restore"] == 1,
          f"{AUDIO}: the decode steps and the row copies launched the "
          f"kernels: {launches}")
    return {"tokens": n, "rows": rows, "cache_len": PARTITION_TOKENS,
            "src_len": cfg.encoder_src_len, "decode_steps": steps + 1,
            "decode_vs_forward_rel_err": err, "tolerance": 5e-2,
            "forward_s": t1 - t0, "prefill_s": t3 - t2,
            "decode_ms_median": float(np.median(walls[1:])) * 1e3,
            "launches": launches}


def phase_seamless(gen) -> tuple[list[dict], dict]:
    """seamless-m4t-medium at full width (12 + 12 layers, d_model 1024,
    16 heads of 64, random bf16 weights from seed 0), then freed: the
    snapshot kernels over its 4-leaf row (self and cross K/V) and
    ``partition_attention`` at its decoder's shapes (Hkv 16, G 1, Dh 64),
    each against its plain version; the model-level path
    (``_seamless_model``), which sets each kernel row's launches; a decode
    step's profile; one train step at 2 x 256 tokens with stub frames."""
    cfg = get_config(AUDIO)
    t0 = time.perf_counter()
    rows = phase_snapshot(cfg, gen, tag=AUDIO)
    rows.append(phase_attention_at(cfg, gen, AUDIO))
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init_params(cfg, 0, device=DEV)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(),
          f"{AUDIO}: {n_params} parameters, the spec says "
          f"{cfg.param_count()}")
    model = _seamless_model(cfg, params)
    for row in rows:
        row["launches"] = model["launches"][row["name"].split("@")[0]]
    emit({"phase": "family_model", "config": AUDIO, "params": n_params,
          "param_bytes": sum(x.numel() * x.element_size()
                             for x in tree_leaves(params)), **model})
    summary = {"model": model, **phase_profile(cfg, params)}

    data = SyntheticTokens(DataConfig(cfg.vocab_size, 256, 2))
    batch = make_batch(cfg, data, 0, DEV)
    batch["frames"] = _frames(cfg, 2, DEV)
    state = {"params": params, "opt": init_opt_state(params)}
    torch.cuda.synchronize(DEV)
    t1 = time.perf_counter()
    state, m = make_train_step(cfg)(state, batch)
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    step = {"batch": 2, "seq": 256, "loss": loss, "grad_norm": norm,
            "wall_s": time.perf_counter() - t1}
    check(np.isfinite(loss) and norm > 0,
          f"{AUDIO}: train step loss {loss}, grad norm {norm}")
    emit({"phase": "train_step", "config": AUDIO, **step})
    summary["train_step"] = step
    summary["seconds"] = time.perf_counter() - t0
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rows, summary


# ---------------------------------------------------------------------------
# Phase 6: where a decode step's time goes
# ---------------------------------------------------------------------------


def _device_kernels(fn, n: int) -> tuple[list, float]:
    """``torch.profiler`` over ``n`` calls of ``fn``: the device kernels as
    (device microseconds, launches, name), longest first, and the host
    wall of the ``n`` calls, ended by a synchronise."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True), wall


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
    kernels, prof_wall = _device_kernels(step, n)
    busy_us = sum(k[0] for k in kernels)
    attn_us = sum(k[0] for k in kernels if "partition_attention" in k[2])
    emit({"phase": "profile", "config": cfg.name, **_cut(cfg),
          "rows": N_PARTITIONS,
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
# Phase 7: the path on the card against the plain path on the CPU
# ---------------------------------------------------------------------------


def phase_reference(arch: str) -> float:
    """The reduced config with the same weights: prefill (qwen2-vl with its
    vision stub and M-RoPE grid positions, seamless with its stub frames)
    + four decode steps with the kernels on the card against the plain
    versions on the CPU.  Tolerance 2e-2 of the largest logit: bf16
    activations round at other places in cuBLAS and in PyTorch's CPU
    kernels; on an MoE model 8e-2, the reference's MoE bound, as in the CPU
    tests: that rounding can flip a top-k choice near a tie."""
    cfg = reduced(get_config(arch))
    params_cpu = M.init_params(cfg, 0, device="cpu")
    params = tree_map(lambda x: x.to(DEV), params_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 16)).astype(np.int32))
    out = {}
    for dev, p in (("cpu", params_cpu), ("cuda", params)):
        caches = M.init_caches(cfg, 2, 32, device=dev)
        batch = {"tokens": toks[:, :12].to(dev)}
        if cfg.vision_stub_tokens:
            batch["vision_embeds"], batch["positions"] = _vision_inputs(
                cfg, 2, 12, dev)
        if cfg.family == "audio":
            batch["frames"] = _frames(cfg, 2, dev)
        lg, caches = M.prefill(cfg, p, batch, caches)
        logits = [lg]
        for i in range(12, 16):
            lg, caches = M.decode_step(
                cfg, p, toks[:, i:i + 1].to(dev),
                torch.full((2,), i, dtype=torch.int32, device=dev), caches)
            logits.append(lg)
        out[dev] = torch.stack(logits).float().cpu()
    err = float((out["cuda"] - out["cpu"]).abs().max())
    scale = float(out["cpu"].abs().max())
    tol = TOL_MOE if cfg.num_experts else 2e-2
    emit({"phase": "reference", "config": cfg.name, "max_abs_err": err,
          "max_abs_logit": scale, "tolerance": tol})
    check(bool(torch.isfinite(out["cuda"]).all()) and err <= tol * scale,
          f"{cfg.name}: card vs CPU logits: {err} > {tol} * {scale}")
    return err


def phase_train_reference(arch: str) -> dict:
    """One train step of the reduced config from the same weights and
    batch, on the card and on the CPU (where the CPU tests hold the port
    to ``jax.grad``): loss within 2e-2 and grad norm within 5e-2 relative,
    ``tests/test_training.py``'s bounds."""
    cfg = reduced(get_config(arch))
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 16, 4))
    out = {}
    for dev in ("cpu", DEV):
        params = M.init_params(cfg, 0, device="cpu")
        params = tree_map(lambda x: x.to(dev), params)
        batch = make_batch(cfg, data, 0, dev)
        if cfg.family == "audio":
            batch["frames"] = _frames(cfg, 4, dev)
        _, m = make_train_step(cfg)(
            {"params": params, "opt": init_opt_state(params)}, batch)
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
    (l0, g0), (l1, g1) = out["cpu"], out[str(DEV)]
    res = {"loss_cpu": l0, "loss_card": l1, "grad_norm_cpu": g0,
           "grad_norm_card": g1}
    emit({"phase": "train_reference", "config": cfg.name, **res})
    check(abs(l1 - l0) < 2e-2 and abs(g1 - g0) < 5e-2 * g0,
          f"{cfg.name}: train step on the card vs the CPU: {res}")
    return res


# ---------------------------------------------------------------------------
# Decode over a "kv_seq"-split cache: the attention kernel on blocks of the
# ring with its softmax partials, a world of two ranks on this card, and
# the paper's end-to-end scenario through launch/serve_elastic.py
# ---------------------------------------------------------------------------

KV_SEQ_BLOCKS = (2, 4)
# (config, windows): gemma2's window (4096) spans the 2048-slot ring, so its
# windowed case takes 512, as phase_attention_at's ring_window_512
KV_SEQ_CASES = (("qwen2-7b", (0,)), ("gemma2-9b", (0, 512)))
# a prompt past the first rank's block of the 2048-slot cache, so that both
# ranks hold valid slots (a 512-token prompt leaves the second block empty
# and weighs it 0 in the merge, which would hide a fault in it)
KV_SEQ_ROWS, KV_SEQ_PROMPT, KV_SEQ_STEPS = 2, 1536, 8
KV_SEQ_WORLD = 2
KV_SEQ_TIMEOUT_S = 300


def _kv_seq_positions(t: int) -> torch.Tensor:
    """pos < 0 (every slot masked); inside the first quarter only; the
    last slot of the first half and the first of the second; the ring's
    last slot; wrapped once and far past t; one more inside."""
    return torch.tensor([-1, 100, t // 2 - 1, t // 2, t - 1, t + 700,
                         10 * t + 123, 3 * t // 4 + 5], dtype=torch.int32,
                        device=DEV)


def _stack_merge(parts):
    """``merge_partials`` over the blocks' partials stacked on dim 0: the
    max and the sums of ``_decode_block``'s all-reduces as reductions."""
    top, lsum, acc = (torch.stack(z) for z in zip(*parts))
    return merge_partials(top, lsum, acc, lambda x: x.amax(0, keepdim=True),
                          lambda x: x.sum(0))


def _block_slots(pos, t: int, window: int, off: int, tb: int) -> list[int]:
    """Valid slots of each row in the block (``block_runs``, the kernel's
    runs), the whole block for pos < 0."""
    return [sum(b - a for a, b in block_runs(int(p), t, window, off, tb))
            for p in pos.tolist()]


def _efficient_call(q, k, v, pos, scale: float, t: int, off: int,
                    window: int):
    """One PyTorch call that returns a block's output and log-sum-exp:
    ``_scaled_dot_product_efficient_attention`` with ``compute_log_sumexp``
    on the unrolled GQA, the block's valid slots as an additive bias (built
    here, outside any timing)."""
    p, hkv, g, dh = q.shape
    tb = k.shape[1]
    slots = off + torch.arange(tb, device=DEV)[None, :]
    at = pos.long()[:, None]
    gidx = at - torch.remainder(at - slots, t)
    valid = gidx >= 0
    if window:
        valid &= gidx > at - window
    bias = torch.zeros((p, hkv * g, 1, tb), dtype=q.dtype, device=DEV)
    bias.masked_fill_(~valid[:, None, None, :], float("-inf"))
    qs = q.reshape(p, hkv * g, 1, dh)
    ks = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    vs = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        qs, ks, vs, bias, True, scale=scale)[:2]


def phase_kv_seq_decode(gen) -> dict:
    """``partition_attention`` on blocks of a ring with ``partials``, at
    full-width qwen2-7b (P 8, t 2048, Hkv 4, G 7, Dh 128) and gemma2-9b
    (Hkv 8, G 2, Dh 256, cap 50, scale 1/16; windows 0 and 512) shapes in
    bf16: the ring cut into 2 and into 4 blocks, each block's partials
    held to the plain version's where the block holds a valid slot for
    the row (max NEG_INF where it holds none), and the blocks merged by
    ``_decode_block``'s merge (``merge_partials``) held to the one-block
    kernel and to the plain version.  The rows include pos < 0, a position
    inside one block only and rings wrapped past t.  Then the time of one
    block's call (the first of two, qwen2-7b, the engine's positions below
    t) against its bound (the bytes of the block's valid slots), the plain
    version and one PyTorch call that returns the output and the
    log-sum-exp.  Its ``launches`` come from the world run
    (``phase_kv_seq_world``), the main path over a split cache."""
    t0 = time.perf_counter()
    ops.reset_launches()
    t, p = PARTITION_TOKENS, N_PARTITIONS
    bf16 = torch.bfloat16
    errs, limits = {}, {}
    for arch, windows in KV_SEQ_CASES:
        cfg = get_config(arch)
        hkv, dh = cfg.num_kv_heads, cfg.head_dim
        g = cfg.num_heads // hkv
        model = {"logit_cap": cfg.attn_logit_softcap,
                 "scale": cfg.query_scale or dh ** -0.5}
        q = randn((p, hkv, g, dh), bf16, gen)
        k = randn((p, t, hkv, dh), bf16, gen)
        v = randn((p, t, hkv, dh), bf16, gen)
        pos = _kv_seq_positions(t)
        for window in windows:
            kw = {"window": window, **model}
            whole = ops.partition_attention(q, k, v, pos, **kw)
            want = ref.partition_attention(q, k, v, pos, **kw)
            for nb in KV_SEQ_BLOCKS:
                tb, parts = t // nb, []
                for off in range(0, t, tb):
                    kb = k[:, off:off + tb].contiguous()
                    vb = v[:, off:off + tb].contiguous()
                    got = ops.partition_attention(q, kb, vb, pos, off=off,
                                                  t=t, partials=True, **kw)
                    wp = ref.partition_attention(q, kb, vb, pos, off=off,
                                                 t=t, partials=True, **kw)
                    parts.append(got)
                    has = torch.tensor(
                        [n > 0 for n in _block_slots(pos, t, window, off,
                                                     tb)], device=DEV)
                    tag = f"{arch}/w{window}/{nb}_blocks/off{off}"
                    check(bool((got[0][~has] == ref.NEG_INF).all()),
                          f"{tag}: a block with no valid slot reports a max "
                          f"other than NEG_INF")
                    for name, a, b in zip(("top", "l", "acc"), got, wp):
                        ok, err = allclose(a[has], b[has], TOL_BF16)
                        check(ok, f"{tag}: partials {name} vs plain: {err}")
                        errs[f"{tag}/{name}"] = err
                    ok, err, limit = attention_close(
                        (got[2] / got[1][..., None])[has],
                        (wp[2] / wp[1][..., None])[has])
                    check(ok, f"{tag}: block output vs plain: {err} > "
                              f"{limit}")
                merged = _stack_merge(parts).to(bf16)
                for name, other in (("one_block_kernel", whole),
                                    ("plain", want)):
                    ok, err, limit = attention_close(merged, other)
                    tag = f"{arch}/w{window}/{nb}_blocks_merged_vs_{name}"
                    check(ok, f"{tag}: {err} within {TOL_BF16} and {limit}")
                    errs[tag], limits[tag] = err, limit
    phase_launches = ops.LAUNCHES["partition_attention"]

    # one block's call at the engine's shapes and positions, timed
    cfg = get_config(ARCH)
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // hkv
    q = randn((p, hkv, g, dh), bf16, gen)
    tb = t // KV_SEQ_BLOCKS[0]
    kb = randn((p, tb, hkv, dh), bf16, gen)
    vb = randn((p, tb, hkv, dh), bf16, gen)
    lo = torch.randint(0, t, (p,), generator=gen, device=DEV,
                       dtype=torch.int32)
    kw = {"off": 0, "t": t, "partials": True}
    kernel = partial(ops.partition_attention, q, kb, vb, lo, **kw)
    plain = partial(ref.partition_attention, q, kb, vb, lo, **kw)
    library = _efficient_call(q, kb, vb, lo, dh ** -0.5, t, 0, 0)
    top, lsum, acc = plain()
    out, lse = library()
    _, lib_err = allclose(out.reshape(p, hkv, g, dh),
                          acc / lsum[..., None], TOL_BF16)
    _, lse_err = allclose(lse[:, :, 0].reshape(p, hkv, g),
                          top + torch.log(lsum),
                          TOL_BF16)
    valid = sum(_block_slots(lo, t, 0, 0, tb))
    item = q.element_size()
    nbytes = 2 * valid * hkv * dh * item + q.numel() * item + 4 * p \
        + 4 * (2 * p * hkv * g + acc.numel())
    flops = 4.0 * valid * hkv * g * dh
    bound_s, bound_by = roofline.bound_seconds(nbytes, flops)
    row = {"name": "partition_attention@kv_seq_partials", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/partition_attention.cu",
           "replaces": "src/repro/kernels/partition_attention.py:70",
           "path": "kv_seq", "max_abs_err": max(errs.values()),
           "ms": median_ms(kernel), "plain_ms": median_ms(plain),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "library_ms": median_ms(library)}
    emit({"phase": "kv_seq_decode", "cases": [list(c) for c in
                                             KV_SEQ_CASES],
          "blocks": list(KV_SEQ_BLOCKS), "positions":
          _kv_seq_positions(t).tolist(), "errors": errs,
          "tight_limits": limits, "comparison_launches": phase_launches,
          "timed": {"shape": [p, tb, hkv, g, dh], "ring": t,
                    "valid_slots": valid, "bytes": nbytes, "flops": flops,
                    "library": "_scaled_dot_product_efficient_attention",
                    "library_max_abs_err": lib_err,
                    "library_lse_max_abs_err": lse_err},
          "seconds": time.perf_counter() - t0, **row})
    return row


_WORLD = r"""
import gc, json, sys, time
import numpy as np
import torch
import torch.distributed as dist
rank, world = int(sys.argv[1]), int(sys.argv[2])
port, out, device = sys.argv[3], sys.argv[4], "cuda"
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
print("group up", flush=True)
from repro_torch import sharding as S
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import (tree_flatten, tree_leaves,
                                       tree_unflatten)
rows, prompt, steps, t = (int(x) for x in sys.argv[5:9])
# "arch:mode,mode;arch:mode"
runs = [(a, m.split(",")) for a, m in
        (r.split(":") for r in sys.argv[9].split(";"))]
ops.load()
print("kernels loaded", flush=True)


def diff(after, before):
    return {k: {n: v - before[k].get(n, 0) for n, v in after[k].items()}
            for k in ("counts", "bytes")}


def run(cfg, params, caches, place, count=None):
    # prefill, then the decode steps, each timed to a synchronize; the
    # collectives of each decode step; the logits gathered whole through
    # the port's own collective, after the timed steps
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(rows, prompt + steps)).astype(np.int32))
    logits, per_step = [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = M.prefill(cfg, params, {"tokens": place(
            toks[:, :prompt].to(device), ("batch", "seq"))}, caches)
        logits.append(lg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(steps):
            before = count.snapshot() if count else None
            pos = torch.full((rows,), prompt + i, dtype=torch.int32,
                             device=device)
            lg, caches = M.decode_step(
                cfg, params, place(toks[:, prompt + i:prompt + i + 1].to(
                    device), ("batch", None)), place(pos, ("batch",)),
                caches)
            logits.append(lg)
            if count:
                per_step.append(diff(count.snapshot(), before))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    logits = torch.stack([S.full_tensor(x) for x in logits]).float()
    torch.cuda.synchronize()
    return logits, caches, {"prefill_seconds": t1 - t0,
                            "steps_seconds": t2 - t1}, per_step


def shards_ok(tree, shardings):
    return all(
        S.is_dtensor(x) and x.placements == sh.placements
        and tuple(x.to_local().shape) == sh.shard_shape(tuple(x.shape))
        for x, sh in zip(tree_leaves(tree), tree_leaves(shardings),
                         strict=True))


def nbytes(x):
    return x.numel() * x.element_size()


def free():
    gc.collect()
    torch.cuda.empty_cache()


res, mesh = {"rank": rank, "archs": {}}, None
for arch, modes in runs:
    cfg, rec_arch = get_config(arch), {"modes": {}}
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        params = M.init_params(cfg, 0, device=device)
        plain, _, rec_arch["plain"], _ = run(
            cfg, params, M.init_caches(cfg, rows, t, device=device),
            lambda x, axes: x)
        rec_arch["plain_peak_bytes"] = torch.cuda.max_memory_allocated()
        del params
        free()
        print(f"{arch}: unsharded run done", flush=True)
    mesh = mesh or make_host_mesh(device)
    for mode in modes:
        rules = S.serve_rules_for(cfg, "decode_32k")
        if mode == "kv_seq":
            # the serving rules' cache split, the weights whole on each rank
            rules = dict(rules, heads=None, mlp=None, vocab=None)
        torch.cuda.reset_peak_memory_stats()
        params = M.init_params(cfg, 0, device=device, mesh=mesh,
                               rules=rules)
        psh = M.param_shardings(cfg, mesh, rules)
        csh = M.cache_shardings(cfg, rows, t, mesh, rules)
        caches = M.init_caches(cfg, rows, t, device=device)
        flat = tree_leaves(caches)
        caches = tree_unflatten(tree_flatten(caches)[1], [
            S.distribute(x, sh) for x, sh in zip(flat, tree_leaves(csh))])
        del flat
        free()
        print(f"{arch} {mode}: placed on the mesh", flush=True)

        def place(x, axes):
            return S.distribute(x, S.named_sharding(axes, tuple(x.shape),
                                                    mesh, rules))

        ops.reset_launches()
        dist.barrier()                  # both ranks start the clock here
        with S.CollectiveCount() as count, S.sharding_ctx(mesh, rules):
            logits, caches, rec, per_step = run(cfg, params, caches, place,
                                                count)
        w = tree_leaves(params)
        rec.update(
            launches=dict(ops.LAUNCHES), functional=count.functional,
            collectives=count.snapshot(), per_step=per_step,
            peak_bytes=torch.cuda.max_memory_allocated(),
            kv_split=[tuple(sh.spec) for sh in tree_leaves(csh)],
            weights_split=sum(any(not p.is_replicate() for p in x.placements)
                              for x in w),
            weight_bytes={"rank": sum(nbytes(x.to_local()) for x in w),
                          "model": sum(nbytes(x) for x in w),
                          "replicated": sum(nbytes(x) for x in w if
                                            x.to_local().numel()
                                            == x.numel())},
            weight_shards_ok=shards_ok(params, psh),
            shards_ok=shards_ok(caches, csh))
        if rank == 0:
            err = (logits - plain).abs()
            rec.update(finite=bool(torch.isfinite(logits).all()),
                       max_abs_err=float(err.max()),
                       step_errors=err.amax((1, 2)).tolist(),
                       max_abs_logit=float(plain.abs().max()),
                       shape=list(logits.shape))
        rec_arch["modes"][mode] = rec
        del params, caches, logits, w
        free()
        print(f"{arch} {mode}: run done", flush=True)
    res["archs"][arch] = rec_arch
    if rank == 0:
        del plain
with open(out, "w") as f:
    json.dump(res, f)
dist.barrier()
dist.destroy_process_group()
"""


def run_world(runs: tuple) -> list[dict]:
    """``_WORLD`` in ``KV_SEQ_WORLD`` processes on one gloo group (on the
    card: both on cuda:0; NCCL refuses two ranks on one device, gloo moves
    CUDA tensors through the host), a (1, 2) host mesh.  For each (arch,
    modes) of ``runs``, full-width: rank 0 first unsharded, then every
    rank through each mode on the mesh: "kv_seq" takes
    ``serve_rules_for(cfg, "decode_32k")``'s cache split with the weights
    whole on each rank, "tp" those rules unmodified (heads, MLP and vocab
    split over "model" too), every collective through
    ``sharding.redistribute``'s c10d ones.  Returns each rank's record
    (arch -> its runs); every process is killed at the timeout or a
    failure."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="world")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    spec = ";".join(f"{arch}:{','.join(modes)}" for arch, modes in runs)
    procs = [subprocess.Popen(
        [sys.executable, "-X", "faulthandler", "-c", _WORLD, str(r),
         str(KV_SEQ_WORLD), str(port), f"{tmp}/rank{r}.json",
         str(KV_SEQ_ROWS), str(KV_SEQ_PROMPT), str(KV_SEQ_STEPS),
         str(PARTITION_TOKENS), spec], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(KV_SEQ_WORLD)]
    try:
        outs = [p.communicate(timeout=KV_SEQ_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, o[-4000:]) for r, (p, o) in
           enumerate(zip(procs, outs)) if p.returncode != 0]
    check(not bad, f"world failed (rank, exit code, output): {bad}")
    return [json.loads(Path(f"{tmp}/rank{r}.json").read_text())["archs"]
            for r in range(KV_SEQ_WORLD)]


def phase_kv_seq_world(row: dict, recs: list[dict]) -> dict:
    """Full-width qwen2-7b decoding over a "kv_seq" axis of two ranks on
    this card (``run_world``'s "kv_seq" mode: the weights whole on each
    rank): 2 rows, a 2048-slot cache, a 1536-token prefill and 8 decode
    steps; the logits within 2e-2 of the largest of the unsharded run's,
    every cache leaf its shard, and the partials kernel launched on both
    ranks (one launch a layer a step), which is ``row``'s launch count."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    modes = [r["modes"]["kv_seq"] for r in recs]
    launches = [m["launches"]["partition_attention"] for m in modes]
    want = _attention_layers(cfg) * KV_SEQ_STEPS
    r0 = modes[0]
    checks = {"finite": r0["finite"],
              "logits_within_2e-2": r0["max_abs_err"]
              <= 2e-2 * r0["max_abs_logit"],
              "kv_seq_split_over_model": any(
                  len(s) >= 3 and s[-3] == "model" for s in r0["kv_split"]),
              "shards_ok": all(m["shards_ok"] for m in modes),
              "partials_on_every_rank": launches == [want] * KV_SEQ_WORLD}
    row["launches"] = sum(launches)
    out = {"config": cfg.name, "world": KV_SEQ_WORLD, "backend": "gloo",
           "rows": KV_SEQ_ROWS, "cache": PARTITION_TOKENS,
           "prompt": KV_SEQ_PROMPT, "steps": KV_SEQ_STEPS,
           "max_abs_err": r0["max_abs_err"],
           "max_abs_logit": r0["max_abs_logit"],
           "step_errors": r0["step_errors"],
           "launches_per_rank": launches, "expected_per_rank": want,
           "rank_seconds": {
               "plain_seconds": sum(recs[0]["plain"].values()),
               "mesh_seconds": r0["prefill_seconds"] + r0["steps_seconds"]},
           "checks": checks, "seconds": time.perf_counter() - t0}
    emit({"phase": "kv_seq_world", **out})
    return out


TP_ARCHS = (ARCH, "gemma2-9b")


def tp_decode_collectives(cfg, rows: int) -> dict:
    """The collectives one decode step issues on each rank under
    ``serve_rules_for(cfg, "decode_32k")`` on a (1, 2) mesh, read off the
    code (a dense decoder whose query heads split over "model", the KV
    heads' weights whole): the embedding's vocab-block sum; per attention
    layer the all-gather of q's heads, the three all-reduces of the
    partials' merge (max, output, normaliser; f32) and the two sums of
    the row-parallel projections (attention output, MLP down) into the
    residual stream (in f32, ``layers.dense_to_stream``).  {kind: (count,
    bytes)}, each call its largest buffer."""
    layers, hq, dh, d = _attention_layers(cfg), cfg.num_heads, \
        cfg.head_dim, cfg.d_model
    embed = rows * d * 2                                # (rows, 1, d) bf16
    merge = rows * hq * 4 * 2 + rows * hq * dh * 4
    return {"all-gather": (layers, layers * rows * hq * dh * 2),
            "all-reduce": (1 + 5 * layers,
                           embed + layers * (merge + 2 * 2 * embed)),
            "reduce-scatter": (0, 0)}


def phase_tp_world(arch: str, recs: list[dict], smi: str) -> dict:
    """Tensor-parallel serving of full-width ``arch`` on two ranks of this
    card (``run_world``'s "tp" mode): the serving rules unmodified, so
    heads, MLP and vocab split over "model" and the caches' "kv_seq" too.
    The logits within 2e-2 of the largest of the unsharded run's; every
    weight and cache leaf its shard; each rank's weight bytes the
    replicated leaves' plus half of the rest; the partials kernel once a
    layer a step on each rank; each decode step's collectives by kind
    those ``tp_decode_collectives`` reads off the code; no call into
    torch's functional collectives."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    modes = [r["modes"]["tp"] for r in recs]
    r0 = modes[0]
    want = _attention_layers(cfg) * KV_SEQ_STEPS
    launches = [m["launches"]["partition_attention"] for m in modes]
    predicted = {k: list(v) for k, v in
                 tp_decode_collectives(cfg, KV_SEQ_ROWS).items()}
    steps = [{k: [s["counts"][k], s["bytes"][k]] for k in predicted}
             for m in modes for s in m["per_step"]]
    wb = [m["weight_bytes"] for m in modes]
    checks = {"finite": r0["finite"],
              "logits_within_2e-2": r0["max_abs_err"]
              <= 2e-2 * r0["max_abs_logit"],
              "weights_split": all(m["weights_split"] > 0 for m in modes),
              "weight_shards_ok": all(m["weight_shards_ok"] for m in modes),
              "cache_shards_ok": all(m["shards_ok"] for m in modes),
              "weight_bytes_half": all(
                  b["rank"] == b["replicated"] + (b["model"] - b["replicated"])
                  // KV_SEQ_WORLD for b in wb),
              "partials_on_every_rank": launches == [want] * KV_SEQ_WORLD,
              "collectives_per_step_as_predicted": len(steps)
              == KV_SEQ_STEPS * KV_SEQ_WORLD
              and all(s == predicted for s in steps),
              "no_functional_collective": all(not m["functional"]
                                              for m in modes)}
    out = {"config": cfg.name, "world": KV_SEQ_WORLD, "backend": "gloo",
           "rules": "serve_rules_for(cfg, 'decode_32k')",
           "rows": KV_SEQ_ROWS, "cache": PARTITION_TOKENS,
           "prompt": KV_SEQ_PROMPT, "steps": KV_SEQ_STEPS,
           "max_abs_err": r0["max_abs_err"],
           "max_abs_logit": r0["max_abs_logit"],
           "step_errors": r0["step_errors"],
           "launches_per_rank": launches, "expected_per_rank": want,
           "decode_step_collectives": steps[0],
           "predicted_per_step": predicted,
           "prefill_and_gather_collectives": [
               {k: [m["collectives"]["counts"][k]
                    - sum(s["counts"][k] for s in m["per_step"]),
                    m["collectives"]["bytes"][k]
                    - sum(s["bytes"][k] for s in m["per_step"])]
                for k in predicted} for m in modes],
           "functional_calls": [m["functional"] for m in modes],
           "weight_bytes": wb,
           "rank_seconds": {
               "unsharded": recs[0]["plain"],
               "sharded": [{k: m[k] for k in ("prefill_seconds",
                                              "steps_seconds")}
                           for m in modes]},
           "peak_bytes": {"unsharded": recs[0]["plain_peak_bytes"],
                          "sharded": [m["peak_bytes"] for m in modes]},
           "device": smi, "checks": checks,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "tp_world", **out})
    return out


def phase_worlds(kv_row: dict, smi: str) -> tuple[dict, dict]:
    """The two-rank world: qwen2-7b through "kv_seq" and "tp", then
    gemma2-9b through "tp", in one pair of processes; their phase
    lines."""
    recs = run_world(tuple((arch, ("kv_seq", "tp") if arch == ARCH
                            else ("tp",)) for arch in TP_ARCHS))
    kv = phase_kv_seq_world(kv_row, [r[ARCH] for r in recs])
    tp = {arch: phase_tp_world(arch, [r[arch] for r in recs], smi)
          for arch in TP_ARCHS}
    bad = {name: [k for k, v in out["checks"].items() if not v]
           for name, out in (("kv_seq", kv), *tp.items())}
    check(not any(bad.values()), f"world checks failed: {bad}")
    return kv, tp


def phase_serve_elastic() -> dict:
    """The paper's end-to-end scenario (``launch/serve_elastic.py``) at
    full width on the card: hotmem, vanilla and static on one bursty
    trace.  Every mode completes what it submitted with nothing killed;
    hotmem reclaims with no migration, vanilla migrates, static reclaims
    nothing.  The launcher's six columns as a JSON line."""
    import contextlib
    import io
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runs = serve_elastic(device="cuda")
    cols = ("completed", "latency_p99", "reclaimed_bytes", "migrated_bytes",
            "reclaim_wall_s")
    table = {mode: {"submitted": m["submitted"], "killed": m["killed"],
                    **{c: m[c] for c in cols}} for mode, m in runs.items()}
    checks = {f"{mode}_completed_all": m["completed"] == m["submitted"]
              and m["killed"] == 0 for mode, m in runs.items()}
    checks["hotmem_migrated_0"] = runs["hotmem"]["migrated_bytes"] == 0
    checks["hotmem_reclaimed"] = runs["hotmem"]["reclaimed_bytes"] > 0
    checks["vanilla_migrated"] = runs["vanilla"]["migrated_bytes"] > 0
    checks["static_reclaimed_0"] = runs["static"]["reclaimed_bytes"] == 0
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    out = {"config": ARCH, "columns": table,
           "printed": buf.getvalue().splitlines()[:4], "checks": checks,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "serve_elastic", **out})
    bad = [k for k, v in checks.items() if not v]
    check(not bad, f"serve_elastic checks failed: {bad}")
    return out



# ---------------------------------------------------------------------------
# The analysis phase: the roofline of the steps measured above, and the dry
# run on this machine's torch
# ---------------------------------------------------------------------------

PROFILE_CELL = ShapeCell("profile", "decode", PARTITION_TOKENS, N_PARTITIONS)
PROFILE_POSITION = PARTITION_TOKENS // 2        # phase_profile's position
TRAIN_CELL = ShapeCell("train", "train", TRAIN_SEQ, TRAIN_BATCH)
BOUND_SHARE = 0.95      # a measured time below 0.95 x its bound is a fault
DRYRUN_CELLS = (("qwen2-7b", "decode_32k"), ("tinyllama-1.1b", "train_4k"))
DRYRUN_TAGS = ("C0-baseline", "C1-int8-weights")
DRYRUN_TIMEOUT_S = 300

_DRYRUN = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.hillclimb import experiments
cells, tags = json.loads(sys.argv[1]), json.loads(sys.argv[2])
recs = [run_cell(a, s, verbose=False) for a, s in cells]
recs += [run_cell(a, s, verbose=False, **kw) for a, s, kw in experiments()
         if kw["tag"] in tags]
for r in recs:
    r.pop("traceback", None)
print(json.dumps(recs))
"""


def _decode_bytes(cfg, cell, position: int) -> float:
    """HBM bytes the decode step at ``position`` must move on one card:
    ``roofline.hbm_traffic_model``'s count (every weight, the whole cache,
    the logits) less what the step does not read, which that model (the
    dry run's, as the reference counts it) keeps: the embedding table but
    the looked-up rows (an untied table; a tied one is read whole by the
    head), and the ring slots past ``position``, which the attention
    kernel skips."""
    tok = M.param_specs(cfg)["embed"]["tok"]
    skipped = 0.0
    if not cfg.tie_embeddings:
        skipped += (tok.shape[0] - cell.global_batch) * tok.shape[1] \
            * tok.dtype.itemsize
    cache = roofline.tree_bytes_per_chip(M.cache_specs(
        cfg, cell.global_batch, cell.seq_len), None, {})
    skipped += cache * (1 - min(position + 1, cell.seq_len) / cell.seq_len)
    return roofline.hbm_traffic_model(cfg, cell, None, {}) - skipped


def _step_roofline(cfg, cell, step, hbm_bytes=None) -> dict:
    """The roofline of one step on one card: FLOPs from ``step`` run once
    on meta tensors under ``roofline.cost_analysis``; HBM bytes
    ``hbm_bytes``, by default ``roofline.hbm_traffic_model`` on no mesh;
    no collectives."""
    with roofline.cost_analysis() as cost:
        step()
    flops = roofline.cost_flops_bytes(cost)[0]
    model_bytes = roofline.hbm_traffic_model(cfg, cell, None, {})
    rl = roofline.Roofline(
        flops=flops, hbm_bytes=model_bytes if hbm_bytes is None
        else hbm_bytes, coll_bytes=0.0,
        model_flops=roofline.model_flops_per_chip(cfg, cell, 1))
    d = rl.as_dict()
    return {"flops": rl.flops, "hbm_bytes": rl.hbm_bytes,
            "traffic_model_bytes": model_bytes,
            "model_flops": rl.model_flops, "compute_ms": d["compute_s"] * 1e3,
            "memory_ms": d["memory_s"] * 1e3,
            "step_bound_ms": d["step_s"] * 1e3, "bound": d["bound"],
            "useful_ratio": d["useful_ratio"]}


def phase_analysis(profile: dict, train: dict) -> dict:
    """(a) The roofline of the two steps this run measured (the qwen2-7b
    ``profile`` decode step, 8 rows of 2048 slots at position 1024, and
    the tinyllama-1.1b ``train`` step, 8 x 1024 tokens with remat), beside
    their measured device and wall times: a device time below
    ``BOUND_SHARE`` of the bound would beat the card, so the count or the
    constants would be wrong.  (b) The dry run on this machine's torch, in
    a process of its own (torch's fake process group is process-wide; the
    card stays hidden from it): ``run_cell`` for ``DRYRUN_CELLS`` on the
    16 x 16 mesh and the hill-climb's ``DRYRUN_TAGS``; each must be traced
    (``ok``), fit the card's memory, count collectives, and int8 weights
    must lower the memory term."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    params, caches = M.abstract_params(cfg), M.abstract_caches(
        cfg, PROFILE_CELL.global_batch, PROFILE_CELL.seq_len)
    toks = torch.empty((N_PARTITIONS, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((N_PARTITIONS,), dtype=torch.int32, device="meta")
    with torch.no_grad():
        steps = {"profile": _step_roofline(
            cfg, PROFILE_CELL,
            lambda: M.decode_step(cfg, params, toks, pos, caches),
            _decode_bytes(cfg, PROFILE_CELL, PROFILE_POSITION))}
    tcfg = get_config(TRAIN_ARCH)
    state = train_state_specs(tcfg, None, None)
    batch = batch_specs(tcfg, TRAIN_CELL, None, None, labels=True)
    steps["train"] = _step_roofline(
        tcfg, TRAIN_CELL, lambda: make_train_step(tcfg)(state, batch))
    del params, caches, state, batch
    checks = {}
    for name, measured in (("profile", profile), ("train", train)):
        st = steps[name]
        st["config"] = cfg.name if name == "profile" else tcfg.name
        st["device_ms"] = measured["device_busy_ms_per_step"]
        st["wall_ms"] = measured["step_ms_median"]
        st["device_over_bound"] = st["device_ms"] / st["step_bound_ms"]
        st["wall_over_bound"] = st["wall_ms"] / st["step_bound_ms"]
        checks[f"{name}_device_at_least_bound"] = \
            st["device_ms"] >= BOUND_SHARE * st["step_bound_ms"]

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"), CUDA_VISIBLE_DEVICES="")
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", _DRYRUN, json.dumps(DRYRUN_CELLS),
         json.dumps(DRYRUN_TAGS)], env=env, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT_S)
    check(res.returncode == 0, f"dry run: {res.stderr[-3000:]}")
    recs = json.loads(res.stdout.strip().splitlines()[-1])
    dry = [{"arch": r["arch"], "shape": r["shape"], "tag": r.get("tag", ""),
            "ok": r["ok"], "error": r.get("error"),
            "fits_hbm": r.get("fits_hbm"), "grad_accum": r.get("grad_accum"),
            "peak_bytes": r.get("memory", {}).get("peak_bytes"),
            "collective_bytes": r.get("collectives", {}).get("total_bytes"),
            "collectives": r.get("collectives", {}).get("bytes_by_op"),
            "roofline": r.get("roofline"), "wall_s": r.get("wall_s")}
           for r in recs]
    for r in dry:
        key = f"{r['arch']}/{r['shape']}{'/' + r['tag'] if r['tag'] else ''}"
        checks[f"{key}_ok"] = bool(r["ok"])
        checks[f"{key}_fits_hbm"] = bool(r["fits_hbm"])
        checks[f"{key}_collectives"] = bool(r["collective_bytes"])
    by_tag = {r["tag"]: r for r in dry if r["tag"]}
    checks["int8_weights_lower_memory_s"] = bool(
        by_tag[DRYRUN_TAGS[1]]["ok"] and by_tag[DRYRUN_TAGS[0]]["ok"]
        and by_tag[DRYRUN_TAGS[1]]["roofline"]["memory_s"]
        < by_tag[DRYRUN_TAGS[0]]["roofline"]["memory_s"])
    out = {"steps": steps, "dryrun": dry,
           "card_total_memory": torch.cuda.get_device_properties(0)
           .total_memory, "dryrun_hbm_per_chip": dryrun.HBM_PER_CHIP,
           "dryrun_seconds": time.perf_counter() - t1, "checks": checks,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "analysis", **out})
    bad = [k for k, v in checks.items() if not v]
    check(not bad, f"analysis checks failed: {bad}")
    return out


def _ok_line() -> None:
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def main(argv: list[str]) -> None:
    if argv not in ([], ["worlds"]):
        raise SystemExit("usage: python3 chip_smoke.py [worlds]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs on an NVIDIA card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_build()
    if argv:                # the two-rank worlds alone
        phase_worlds({}, smi)
        emit({"phase": "done", "seconds": time.perf_counter() - t0})
        print(smi, flush=True)
        _ok_line()
        return
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    rows = [phase_attention(cfg, gen), phase_paged_attention(cfg, gen),
            phase_kv_compact(cfg, gen)] + phase_snapshot(cfg, gen)
    rows.append(phase_decode_qkv_rope(cfg))
    torch.cuda.empty_cache()
    seconds = {"kernels": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out
    # a generator of its own, so that the later phases draw what they drew
    kv_gen = torch.Generator(device=DEV)
    kv_gen.manual_seed(1)
    kv_row = timed("kv_seq_decode", phase_kv_seq_decode, kv_gen)
    rows.append(kv_row)
    torch.cuda.empty_cache()
    summary_kv, summary_tp = timed("worlds", phase_worlds, kv_row, smi)
    launches, params, summary = timed("engine", phase_engine, cfg, gen)
    cluster_launches, summary["cluster"] = timed("cluster", phase_cluster,
                                                 cfg, params, gen)
    summary.update(timed("profile", phase_profile, cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    summary["kv_seq_world"] = summary_kv
    summary["tp_world"] = summary_tp
    summary["serve_elastic"] = timed("serve_elastic", phase_serve_elastic)
    for arch in FAMILIES:
        more, summary[arch] = timed(arch, phase_family, arch, gen)
        rows += more
    summary[VLM] = timed(VLM, phase_vlm)
    summary["train"] = timed("train", phase_train)
    summary["mesh"] = timed("mesh", phase_mesh, summary["train"], gen)
    summary["analysis"] = timed("analysis", phase_analysis, summary,
                                summary["train"])
    more, summary[AUDIO] = timed(AUDIO, phase_seamless, gen)
    rows += more
    summary["reference_max_abs_err"] = timed("reference", lambda: {
        arch: phase_reference(arch)
        for arch in (ARCH, *FAMILIES, VLM, AUDIO)})
    summary["train_reference"] = timed("train_reference", lambda: {
        arch: phase_train_reference(arch) for arch in (TRAIN_ARCH, AUDIO)})
    summary["phase_seconds"] = seconds
    for row in rows:
        # each kernel's count from the runs of the paths that drive it: the
        # engine and cluster runs, each counted from 0, or the
        # layout-contrast entry point
        if row["path"] == "engine":
            row["launches"] = launches[row["name"]] \
                + cluster_launches[row["name"]]
            check(cluster_launches[row["name"]] > 0,
                  f"{row['name']} ran on the cluster path")
        elif row["path"] in ("family", "kv_seq"):
            pass            # counted on its model's engine or world run
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
    _ok_line()


if __name__ == "__main__":
    main(sys.argv[1:])
