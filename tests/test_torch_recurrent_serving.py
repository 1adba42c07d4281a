"""The hotmem ``ServeEngine`` of the port on the recurrent families (reduced
mamba2-780m and recurrentgemma-2b, the kernels' plain versions) against
the JAX package's engine, and the snapshot data plane over their cache
trees: constant-size SSM state, RG-LRU state and conv tails, local
attention rings, and unstacked tail leaves whose batch axis is 0.

Data movement is held byte for byte.  Engine schedules are compared under
``_FakeClock`` (each clock reading advances 1e-4 s) patched into the
engine, elastic, hotmem and vanilla modules of both packages, as in
``tests/test_torch_cluster.py``: the two engines read the clock at the
same points, so every ``StepEvent`` must agree exactly."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from collections import deque
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.elastic as jax_elastic_mod
import repro.core.hotmem as jax_hotmem_mod
import repro.core.vanilla as jax_vanilla_mod
import repro.serving.engine as jax_engine_mod
import repro.serving.request as jax_request
import repro.serving.tracegen as jax_tracegen
import repro_torch.core.elastic as elastic_mod
import repro_torch.core.hotmem as hotmem_mod
import repro_torch.core.vanilla as vanilla_mod
import repro_torch.serving.engine as engine_mod
from repro.cluster.host import HostMemoryBroker as JaxHostMemoryBroker
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.arena import ArenaSpec as JaxArenaSpec
from repro.models import model as JM
from repro_torch.cluster.host import HostMemoryBroker
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.core.arena import ArenaSpec
from repro_torch.kernels import kv_snapshot
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_map_specs
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import PROFILES, Request
from repro_torch.serving.tracegen import assign_profiles, bursty_trace

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
RECURRENT = ["mamba2-780m", "recurrentgemma-2b"]
SNAP_CONFIGS = ["qwen2-7b", "mamba2-780m", "recurrentgemma-2b"]
TORCH_MODULES = (engine_mod, elastic_mod, hotmem_mod, vanilla_mod)
JAX_MODULES = (jax_engine_mod, jax_elastic_mod, jax_hotmem_mod,
               jax_vanilla_mod)


class _FakeClock:
    """Deterministic stand-in for ``time``: each perf_counter() call
    advances a fixed step."""

    def __init__(self, step=1e-4):
        self._t = 0.0
        self._step = step

    def perf_counter(self):
        self._t += self._step
        return self._t


def _fake_time(monkeypatch, modules):
    clock = _FakeClock()
    for mod in modules:
        monkeypatch.setattr(mod, "time", clock)


@pytest.fixture(scope="module", params=RECURRENT)
def setup(request):
    """Reduced config, the JAX parameters from ``PRNGKey(0)`` and the
    same weights moved into the port; 8 partitions of 128 tokens."""
    jcfg = jax_reduced(jax_get_config(request.param))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(request.param))
    params = tree_from_numpy(jax.device_get(jparams), "cpu")
    spec = ArenaSpec.from_model(cfg, partition_tokens=128, n_partitions=8,
                                block_tokens=32)
    jspec = JaxArenaSpec.from_model(jcfg, partition_tokens=128,
                                    n_partitions=8, block_tokens=32)
    assert dataclasses.astuple(jspec) == dataclasses.astuple(spec)
    return cfg, params, spec, (jcfg, jparams, jspec)


def _random_caches(cfg, rows, t, seed=0):
    caches = M.init_caches(cfg, rows, t, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for x in tree_leaves(caches):
        x.copy_(torch.randn(x.shape, generator=gen))
    return caches


def _to_jax(caches):
    return jax.tree.map(
        lambda x: jnp.asarray(x.view(torch.int16).numpy().view(
            jnp.bfloat16)), caches)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).view(np.uint8).tobytes()


# ------------------------------------------------ snapshot data plane


@pytest.mark.parametrize("arch", SNAP_CONFIGS)
@pytest.mark.parametrize("rows", [[1], [2, 0]])
def test_capture_blob_equals_the_jax_blob(arch, rows):
    """The port's plain capture of the same cache bytes gives the JAX
    ``impl="ref"`` blob byte for byte (``tests/test_kernels.py``'s
    ``SNAP_CONFIGS`` trees)."""
    cfg = reduced(get_config(arch))
    caches = _random_caches(cfg, 3, 16, seed=len(rows))
    got = M.cache_read_rows(caches, rows)
    want = JM.cache_read_rows(_to_jax(caches),
                              jnp.asarray(rows, jnp.int32), impl="ref")
    assert tuple(got.shape) == tuple(want.shape)
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("arch", SNAP_CONFIGS)
def test_restore_equals_the_jax_restore(arch):
    cfg = reduced(get_config(arch))
    caches = _random_caches(cfg, 3, 16, seed=5)
    layout = M.cache_row_layout(caches)
    blob = torch.randn((2, layout.total_elems),
                       generator=torch.Generator().manual_seed(6)).to(
        layout.torch_dtype)
    want = JM.cache_write_rows(
        _to_jax(caches), jnp.asarray(blob.view(torch.int16).numpy().view(
            jnp.bfloat16)), jnp.asarray([2, 0], jnp.int32), impl="ref")
    got = M.cache_write_rows(caches, blob, [2, 0])
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        assert _bytes(g) == _bytes(w)


def _emulate_capture(leaves, blob_shape, layout, rows):
    """The CUDA kernel's address arithmetic in numpy, from the descriptors
    ``copy_plan`` hands it: unit e of chunk o of row r of a leaf sits at
    unit (o * batch + r) * inner + e."""
    blob = torch.empty(blob_shape, dtype=layout.torch_dtype)
    unit, desc = kv_snapshot.copy_plan(leaves, blob, layout)
    out = np.zeros((len(rows), layout.row_bytes // unit, unit), np.uint8)
    for i, leaf in enumerate(leaves):
        outer, batch, inner, offset = desc[4 * i:4 * i + 4]
        src = leaf.contiguous().view(torch.uint8).numpy().reshape(-1, unit)
        for n, r in enumerate(rows):
            idx = ((np.arange(outer)[:, None] * batch + r) * inner
                   + np.arange(inner)[None, :]).reshape(-1)
            out[n, offset:offset + outer * inner] = src[idx]
    return out.reshape(len(rows), -1)


@pytest.mark.parametrize("arch", SNAP_CONFIGS)
def test_kernel_copy_plan_addresses_every_leaf(arch):
    """The descriptors the CUDA kernel gets, replayed on the CPU, give the
    plain capture's blob: the stacked leaves (batch axis 1, ``outer`` =
    n_groups) and the tail leaves (batch axis 0, ``outer`` = 1) alike."""
    cfg = reduced(get_config(arch))
    caches = _random_caches(cfg, 4, 16, seed=7)
    leaves, axes, _ = M.cache_flat_axes(caches)
    layout = M.cache_row_layout(caches)
    rows = [3, 0, 2]
    want = M.cache_read_rows(caches, rows).view(torch.uint8).numpy()
    got = _emulate_capture(leaves, (len(rows), layout.total_elems), layout,
                           rows)
    assert np.array_equal(got, want)
    _unit, desc = kv_snapshot.copy_plan(
        leaves, torch.empty((1, layout.total_elems),
                            dtype=layout.torch_dtype), layout)
    for i, ax in enumerate(axes):
        assert desc[4 * i] == (1 if ax == 0 else leaves[i].shape[0])


@pytest.mark.parametrize("arch,n_leaves,row_bytes,pages", [
    ("qwen2-7b", 2, 117_440_512, 56),
    ("mamba2-780m", 4, 38_707_200, 19),
    ("recurrentgemma-2b", 10, 17_145_856, 9)])
def test_full_width_trees_fit_the_snapshot_kernel(arch, n_leaves, row_bytes,
                                                  pages):
    """Full-width 8 x 2048 cache trees, on the meta device (no memory):
    the layout's bytes equal the spec's, the leaves fit one launch, the
    copy unit is 16 bytes (768 B, 5,120 B and 15,360 B slices included),
    and the 2 MiB page count of a row (the last page partial unless the
    row is a whole number of pages)."""
    cfg = get_config(arch)
    caches = tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        M.cache_specs(cfg, 8, 2048))
    leaves, _axes, _ = M.cache_flat_axes(caches)
    layout = M.cache_row_layout(caches)
    assert len(leaves) == n_leaves <= kv_snapshot.MAX_LEAVES
    assert layout.row_bytes == row_bytes == \
        kv_snapshot.expected_row_bytes(cfg, 2048)
    blob = torch.empty((1, layout.total_elems), dtype=layout.torch_dtype,
                       device="meta")
    unit, desc = kv_snapshot.copy_plan(leaves, blob, layout)
    assert unit == 16
    slice_bytes = {d * unit for d in desc[2::4]}
    assert all(b % 16 == 0 for b in slice_bytes)
    if arch != "qwen2-7b":
        assert min(slice_bytes) in (768, 5_120)
    assert math.ceil(row_bytes / (2 << 20)) == pages
    assert (row_bytes % (2 << 20) == 0) == (arch == "qwen2-7b")


def test_copy_plan_refuses_more_leaves_than_one_launch_takes():
    x = torch.zeros((1, 2, 16), dtype=torch.bfloat16)
    leaves = [x] * (kv_snapshot.MAX_LEAVES + 1)
    layout = kv_snapshot.build_layout(leaves, [1] * len(leaves))
    blob = torch.empty((1, layout.total_elems), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kv_snapshot.copy_plan(leaves, blob, layout)


# ------------------------------------------------ row-wise utilities


def test_row_utilities_keep_tail_leaves_on_axis_0():
    cfg = reduced(get_config("recurrentgemma-2b"))
    caches = _random_caches(cfg, 4, 16, seed=8)
    row = M.cache_read_row(caches, 2)
    assert [x.shape[0] for x in row["tail"][0].values()] == [1, 1]
    other = M.init_caches(cfg, 4, 16, device="cpu")
    M.cache_write_row(other, row, 3)
    assert torch.equal(other["tail"][1]["state"][3],
                       caches["tail"][1]["state"][2])
    assert torch.equal(other["groups"][2]["k"][:, 3],
                       caches["groups"][2]["k"][:, 2])
    small = M.cache_slice_rows(caches, 2)
    big = M.cache_grow_rows(small, 5)
    assert M.cache_num_rows(small) == 2 and M.cache_num_rows(big) == 5
    assert torch.equal(big["tail"][0]["conv"][:2], caches["tail"][0][
        "conv"][:2])
    assert not big["tail"][0]["conv"][2:].any()
    assert torch.equal(big["groups"][0]["conv"][:, :2],
                       caches["groups"][0]["conv"][:, :2])


# ------------------------------------------------ the engine


def _trace(pkg, seed=3, duration=16.0):
    """The bursty trace of ``tests/test_serving.py:26`` (23 requests)."""
    if pkg == "jax":
        trace, assign = jax_tracegen.bursty_trace, \
            jax_tracegen.assign_profiles
        req_cls, profiles = jax_request.Request, jax_request.PROFILES
    else:
        trace, assign = bursty_trace, assign_profiles
        req_cls, profiles = Request, PROFILES
    arr = trace(duration, 0.8, burst_x=6, burst_at=(0.0,), burst_len=3.0,
                quiet_after=duration / 2, seed=seed)
    return [req_cls(rid=f"b{i}", profile=p, submit_s=t)
            for i, (t, p) in enumerate(assign(arr, profiles, seed))]


def _burst_run(setup, monkeypatch, pkg):
    cfg, params, spec, (jcfg, jparams, jspec) = setup
    if pkg == "jax":
        _fake_time(monkeypatch, JAX_MODULES)
        eng = jax_engine_mod.ServeEngine(jcfg, jparams, jspec,
                                         mode="hotmem", keep_alive=3.0)
    else:
        _fake_time(monkeypatch, TORCH_MODULES)
        eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=3.0)
    reqs = _trace(pkg)
    m = eng.run(reqs, max_virtual_s=2000)
    eng.arena.manager.check_invariants()
    return {"n": len(reqs),
            "metrics": {k: m[k] for k in (
                "completed", "killed", "reclaim_events", "reclaimed_bytes",
                "migrated_bytes", "decode_steps", "cold_starts",
                "warm_starts", "restore_starts", "latency_p50",
                "latency_p99")},
            "events": [(e.t, e.kind, e.wall_s, e.detail) for e in eng.events]}


def test_bursty_trace_matches_jax(setup, monkeypatch):
    """The bursty trace plugs up the ladder and unplugs back down; under
    one deterministic clock both engines give the same ``StepEvent``
    sequence (kinds, order, times, details), start paths and reclaimed
    bytes, with zero migration and nothing killed."""
    want = _burst_run(setup, monkeypatch, "jax")
    got = _burst_run(setup, monkeypatch, "torch")
    assert got["metrics"] == want["metrics"]
    assert got["metrics"]["completed"] == got["n"] == 23
    assert got["metrics"]["killed"] == 0
    assert got["metrics"]["migrated_bytes"] == 0
    assert got["metrics"]["reclaimed_bytes"] > 0
    assert [e[1] for e in got["events"]] == [e[1] for e in want["events"]]
    assert {"plug", "unplug", "prefill", "decode"} <= \
        {e[1] for e in got["events"]}
    assert got["events"] == want["events"]


def _pooled(setup, pkg, **kw):
    cfg, params, spec, (jcfg, jparams, jspec) = setup
    bpp = spec.blocks_per_partition
    if pkg == "jax":
        broker = JaxHostMemoryBroker(budget_units=12 * bpp,
                                     snapshot_pool_units=4 * bpp)
        return broker, jax_engine_mod.ServeEngine(
            jcfg, jparams, jspec, mode="hotmem", keep_alive=2.0, seed=0,
            broker=broker, replica_id="A", snapshot_impl="ref", **kw)
    broker = HostMemoryBroker(budget_units=12 * bpp,
                              snapshot_pool_units=4 * bpp)
    return broker, ServeEngine(cfg, params, spec, mode="hotmem",
                               keep_alive=2.0, seed=0, broker=broker,
                               replica_id="A", **kw)


def _run_one(eng, rid, prof="cnn", pkg="torch"):
    req_cls, profiles = (jax_request.Request, jax_request.PROFILES) \
        if pkg == "jax" else (Request, PROFILES)
    eng.submit(req_cls(rid=rid, profile=profiles[prof], submit_s=eng.now))
    empty = deque()
    while eng.active or eng.pending:
        eng._tick(empty)


def _expire(eng):
    eng.now += eng.keep_alive + 1.0
    eng._recycle_idle()


def _snapshot_schedule(setup, monkeypatch, pkg):
    """Cold, warm, capture on expiry, restore, restore (the schedule of
    ``tests/test_snapshots.py:360``)."""
    _fake_time(monkeypatch, JAX_MODULES if pkg == "jax" else TORCH_MODULES)
    broker, eng = _pooled(setup, pkg)
    _run_one(eng, "c0", pkg=pkg)
    _run_one(eng, "w0", pkg=pkg)
    _expire(eng)
    _run_one(eng, "s0", pkg=pkg)
    _expire(eng)
    _run_one(eng, "s1", pkg=pkg)
    broker.check_invariants()
    return eng


def test_snapshot_schedule_matches_jax(setup, monkeypatch):
    """The restore path is taken twice, as in the JAX engine, and every
    ``StepEvent`` agrees (the captured bytes are the spec's row bytes)."""
    cfg, _params, spec, _ = setup
    want = _snapshot_schedule(setup, monkeypatch, "jax")
    got = _snapshot_schedule(setup, monkeypatch, "torch")
    starts = (got.cold_starts, got.warm_starts, got.restore_starts)
    assert starts == (want.cold_starts, want.warm_starts,
                      want.restore_starts) == (1, 1, 2)
    assert [(e.t, e.kind, e.wall_s, e.detail) for e in got.events] == \
        [(e.t, e.kind, e.wall_s, e.detail) for e in want.events]
    snap = [e for e in got.events if e.kind == "snapshot"]
    assert len(snap) == 1 and snap[0].detail["bytes"] == \
        kv_snapshot.expected_row_bytes(cfg, spec.partition_tokens)


def test_restored_row_equals_its_captured_blob(setup):
    """The row a restore writes equals the blob the capture took, byte for
    byte, read right after the restore (a decode step would advance the
    recurrent state), and one fused launch did each side."""
    broker, eng = _pooled(setup, "torch")
    _run_one(eng, "c0")
    kv_snapshot.reset_stats()
    _expire(eng)
    blob = broker.snapshot_lookup("cnn").payload.blob
    eng.submit(Request(rid="s0", profile=PROFILES["cnn"], submit_s=eng.now))
    eng._try_admit()
    assert eng.restore_starts == 1
    row = eng.active["s0"].partition
    back = M.cache_read_rows(eng.caches, [row])
    assert _bytes(back) == blob.tobytes()
    s = kv_snapshot.STATS
    assert (s["capture_launches"], s["restore_launches"]) == (1, 1)
    assert s["d2h_bytes"] == s["h2d_bytes"] == blob.nbytes


def test_paged_cow_restore_remaps_a_partial_last_page(setup):
    """Pages of 1000 B cut the row into pages whose last one is partial;
    a local restore with every page mapped moves zero host->device bytes
    and writes the captured bytes back."""
    broker, eng = _pooled(setup, "torch", snapshot_page_bytes=1000)
    _run_one(eng, "c0")
    _expire(eng)
    snap = broker.snapshots.peek("cnn")
    row_bytes = eng._snapshot_layout().row_bytes
    assert row_bytes % 1000 != 0
    assert len(snap.pages) == math.ceil(row_bytes / 1000)
    blob = engine_mod.assemble_pages(broker.snapshot_page_specs("cnn"))
    kv_snapshot.reset_stats()
    eng.submit(Request(rid="r0", profile=PROFILES["cnn"], submit_s=eng.now))
    eng._try_admit()
    s = kv_snapshot.STATS
    assert s["remap_restores"] == 1 and s["h2d_bytes"] == 0
    back = M.cache_read_rows(eng.caches, [eng.active["r0"].partition])
    assert _bytes(back) == blob.tobytes()


def test_unplug_frees_the_dropped_rows(setup):
    """After an unplug no cache tensor, stacked or tail, shares storage
    with the pre-unplug ones, and the reclaimed bytes are the rows'."""
    cfg, params, spec, _ = setup
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=1.0)
    eng._grow_and_sync(6, via_gate=True)
    old = {x.untyped_storage().data_ptr() for x in tree_leaves(eng.caches)}
    ev = eng._unplug_now(4)
    assert ev.reclaimed_units == 4 and ev.migrated_bytes == 0
    assert eng._rows() == 4
    for x in tree_leaves(eng.caches):
        assert x.untyped_storage().data_ptr() not in old
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
    assert ev.reclaimed_bytes == 4 * spec.bytes_per_partition
    assert sum(x.numel() * x.element_size() for x in
               tree_leaves(eng.caches)) == 4 * spec.bytes_per_partition


def test_vanilla_mode_is_refused(setup):
    """The paged baseline mirrors token-extensive KV only: both packages
    refuse it on the recurrent families."""
    cfg, params, spec, (jcfg, jparams, jspec) = setup
    with pytest.raises(AssertionError, match="token-extensive"):
        ServeEngine(cfg, params, spec, mode="vanilla")
    with pytest.raises(AssertionError, match="token-extensive"):
        jax_engine_mod.ServeEngine(jcfg, jparams, jspec, mode="vanilla")


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_launcher_runs_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch ... --reduced --device
    cpu`` serves the bursty trace to the end."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--duration", "4"],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    m = json.loads(res.stdout)
    assert m["completed"] > 0 and m["killed"] == 0
    assert m["migrated_bytes"] == 0
