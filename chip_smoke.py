#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``src/repro_torch``) runs on one
NVIDIA card: builds the hand-written kernels, holds each against its plain
PyTorch version at the shapes of the main path, then drives the hotmem
``ServeEngine`` on full-width qwen2-7b (random weights from a seed) through
cold start, warm start, snapshot capture, restore, the paged copy-on-write
remap, plug and unplug, and checks what comes out.

    python3 chip_smoke.py

Every phase prints one JSON line.  The script fails (raises, non-zero exit)
when there is no CUDA device, when a kernel does not build, launch or agree
with its plain version, or when any check of the engine run fails.  A
``summary`` line repeats the engine's headline figures near the end.  The
last three lines are the kernel table, the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import deque
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
from repro_torch.kernels import kv_snapshot, ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.request import PROFILES, Request  # noqa: E402
from repro_torch.serving.tracegen import (assign_profiles,  # noqa: E402
                                          bursty_trace)

ARCH = "qwen2-7b"
PARTITION_TOKENS, N_PARTITIONS, BLOCK_TOKENS = 2048, 8, 32
PAGE_BYTES = 2 << 20            # paged CoW: 56 pages of one 112 MiB row
TOL_BF16, TOL_F32 = 2e-2, 2e-5  # the JAX package's kernel-test tolerances
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
    row = {"name": "partition_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/partition_attention.cu",
           "replaces": "src/repro/kernels/partition_attention.py:70",
           "max_abs_err": errs["main"], "ms": median_ms(kernel),
           "plain_ms": median_ms(plain),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "library_ms": median_ms(sdpa)}
    emit({"phase": "kernel", "shape": [p, t, hkv, g, dh], "dtype": "bf16",
          "valid_slots": valid, "bytes": nbytes, "flops": flops,
          "errors": errs, "tight_limits": limits,
          "planted_fault_errors": faults, "sdpa_max_abs_err": sdpa_err,
          **row})
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
    out = [
        {"name": "snapshot_capture", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kv_snapshot.cu",
         "replaces": "src/repro/kernels/kv_snapshot.py:123",
         "max_abs_err": 0.0, "ms": median_ms(capture),
         "plain_ms": median_ms(plain_capture),
         "bound_ms": bound_s * 1e3, "bound_by": bound_by,
         "library_ms": median_ms(lib_capture)},
        {"name": "snapshot_restore", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kv_snapshot.cu",
         "replaces": "src/repro/kernels/kv_snapshot.py:160",
         "max_abs_err": 0.0, "ms": median_ms(restore),
         "plain_ms": median_ms(plain_restore),
         "bound_ms": bound_s * 1e3, "bound_by": bound_by,
         "library_ms": median_ms(lib_restore)},
    ]
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


def phase_engine(cfg) -> tuple[dict, dict, dict]:
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
    engines = (snap, cow_a, cow_b, burst)

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
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(ops.LAUNCHES)
    stats = dict(kv_snapshot.STATS)

    decode_steps = sum(e.metrics()["decode_steps"] for e in engines)
    row_bytes = kv_snapshot.expected_row_bytes(cfg, PARTITION_TOKENS)
    cow_ev = [e for e in cow_a.events if e.kind == "restore"]
    checks = {
        "completed == submitted": m_burst["completed"] == len(reqs),
        "killed == 0": m_burst["killed"] == 0 and all(
            e.metrics()["killed"] == 0 for e in engines),
        "migrated_bytes == 0": all(
            e.metrics()["migrated_bytes"] == 0 for e in engines),
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
    burst_walls = {k: [e.wall_s * 1e3 for e in burst.events if e.kind == k]
                   for k in ("decode", "prefill", "plug", "unplug")}
    wall_stats = {k: {"n": len(v), "median": float(np.median(v)),
                      "p90": float(np.percentile(v, 90)), "max": max(v)}
                  for k, v in burst_walls.items() if v}
    emit({"phase": "engine", "run_seconds": run_s,
          "decode_steps": decode_steps, "launches": launches,
          "stats": stats, "unplug_memory": drops,
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
               "reclaimed_bytes": m_burst["reclaimed_bytes"]}
    return launches, params, summary


# ---------------------------------------------------------------------------
# Phase 4: where a decode step's time goes
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
# Phase 5: the path on the card against the plain path on the CPU
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
    rows = [phase_attention(cfg, gen)] + phase_snapshot(cfg, gen)
    torch.cuda.empty_cache()
    launches, params, summary = phase_engine(cfg)
    summary.update(phase_profile(cfg, params))
    del params
    summary["reference_max_abs_err"] = phase_reference()
    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] > 0, f"{row['name']} ran on the main path")
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
